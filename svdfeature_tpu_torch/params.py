# Verbatim copy of svdfeature_tpu/params.py; tests/test_torch_data.py keeps the two identical.
"""Parameter structs with the reference's stringly-typed set_param flow.

Mirrors SVDTypeParam / SVDTrainParam / SVDModelParam / ParameterSet
(apex_svd_model.h:242-477, solvers/base-solver/apex_svd_base.h:33-75).
Each struct pattern-matches the keys it knows and silently ignores the
rest; the ConfigSaver replays every (name, val) pair into every struct.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import List

import numpy as np

# ---------------------------------------------------------------------------
# format / input type enums (apex_svd_model.h:50-57, apex_svd_data.h:510-523)


class svd_type:
    RANDOM_ORDER_FORMAT = 0
    USER_GROUP_FORMAT = 1
    AUTO_DETECT = 2


class input_type:
    BINARY_BUFFER = 0
    TEXT_FEATURE = 1
    BINARY_BUFFER_RANK = 2
    TEXT_FEATURE_RANK = 3
    TEXT_BASIC = 4
    BINARY_PAGE = 5


class svdpp_tag:
    DEFAULT = 0
    START_TAG = 1
    END_TAG = 2
    MIDDLE_TAG = 3


class svdranker_tag:
    """Ranker streaming-protocol tags carried in the label field
    (apex_svd.h:116-154)."""

    ITEM_TAG = 0
    POS_SAMPLE = 1
    USER_TAG = 2
    SPEC_SAMPLE = 3
    PROCESS_TAG = 4
    BAN_SAMPLE = -1


# ---------------------------------------------------------------------------


@dataclass(unsafe_hash=True)
class SVDTypeParam:
    """Solver type selector (apex_svd_model.h:242-287), 4 bytes on disk."""

    format_type: int = svd_type.AUTO_DETECT
    active_type: int = 0
    extend_type: int = 0
    variant_type: int = 0

    def set_param(self, name: str, val: str) -> None:
        if name in ("model_type", "format_type"):
            self.format_type = int(val) & 0xFF
        if name == "active_type":
            self.active_type = int(val) & 0xFF
        if name == "extend_type":
            self.extend_type = int(val) & 0xFF
        if name == "variant_type":
            self.variant_type = int(val) & 0xFF

    def decide_format(self, fmt: int = svd_type.AUTO_DETECT) -> None:
        """apex_svd_model.h:279-286."""
        if self.format_type != svd_type.AUTO_DETECT:
            return
        self.format_type = fmt
        if self.format_type != svd_type.AUTO_DETECT:
            return
        self.format_type = (
            svd_type.RANDOM_ORDER_FORMAT
            if self.extend_type == 0
            else svd_type.USER_GROUP_FORMAT
        )

    # binary layout: 4 uint8 in declared order
    def to_bytes(self) -> bytes:
        return bytes(
            [self.format_type, self.active_type, self.extend_type, self.variant_type]
        )

    @classmethod
    def from_bytes(cls, b: bytes) -> "SVDTypeParam":
        return cls(b[0], b[1], b[2], b[3])


@dataclass(unsafe_hash=True)
class SVDTrainParam:
    """Training hyper-parameters (apex_svd_model.h:291-368)."""

    learning_rate: float = 0.01
    decay_learning_rate: int = 0
    decay_rate: float = 1.0
    min_learning_rate: float = 0.0
    wd_user: float = 0.0
    wd_item: float = 0.0
    wd_user_bias: float = 0.0
    wd_item_bias: float = 0.0
    reg_method: int = 0
    wd_global: float = 0.0
    reg_global: int = 0
    num_regfree_global: int = 0
    scale_lr_ufeedback: float = 1.0
    wd_ufeedback_user: float = 0.0
    wd_ufeedback: float = 0.0
    wd_ufeedback_bias: float = 0.0

    def set_param(self, name: str, val: str) -> None:
        f, i = float, int
        if name == "learning_rate":
            self.learning_rate = f(val)
        if name == "wd_user":
            self.wd_user = f(val)
        if name == "wd_item":
            self.wd_item = f(val)
        if name == "wd_uiset":
            self.wd_user = self.wd_item = f(val)
        if name == "wd_user_bias":
            self.wd_user_bias = f(val)
        if name == "wd_item_bias":
            self.wd_item_bias = f(val)
        if name == "wd_uiset_bias":
            self.wd_user_bias = self.wd_item_bias = f(val)
        if name == "wd_global":
            self.wd_global = f(val)
        if name == "reg_method":
            self.reg_method = i(val)
        if name == "reg_global":
            self.reg_global = i(val)
        if name == "num_regfree_global":
            self.num_regfree_global = i(val)
        if name == "decay_learning_rate":
            self.decay_learning_rate = i(val)
        if name == "min_learning_rate":
            self.min_learning_rate = f(val)
        if name == "decay_rate":
            self.decay_rate = f(val)
        if name == "scale_lr_ufeedback":
            self.scale_lr_ufeedback = f(val)
        if name == "wd_ufeedback":
            self.wd_ufeedback = f(val)
        if name == "wd_ufeedback_bias":
            self.wd_ufeedback_bias = f(val)


# exact binary layout of SVDModelParam (apex_svd_model.h:373-450):
# 17 declared 4-byte fields in order, then int reserved[247] -> 1056 bytes.
_MODEL_PARAM_DTYPE = np.dtype(
    [
        ("num_user", "<i4"),
        ("num_item", "<i4"),
        ("num_factor", "<i4"),
        ("num_global", "<i4"),
        ("u_init_sigma", "<f4"),
        ("i_init_sigma", "<f4"),
        ("base_score", "<f4"),
        ("no_user_bias", "<i4"),
        ("num_ufeedback", "<i4"),
        ("ufeedback_init_sigma", "<f4"),
        ("num_randinit_ufactor", "<i4"),
        ("num_randinit_ifactor", "<i4"),
        ("common_latent_space", "<i4"),
        ("user_nonnegative", "<i4"),
        ("common_feedback_space", "<i4"),
        ("extend_flag", "<i4"),
        ("item_nonnegative", "<i4"),
        ("reserved", "<i4", (247,)),
    ]
)
assert _MODEL_PARAM_DTYPE.itemsize == 1056


@dataclass(unsafe_hash=True)
class SVDModelParam:
    """Model hyper-parameters (apex_svd_model.h:373-477)."""

    num_user: int = 0
    num_item: int = 0
    num_factor: int = 0
    num_global: int = 0
    u_init_sigma: float = 0.01
    i_init_sigma: float = 0.01
    base_score: float = 0.5
    no_user_bias: int = 0
    num_ufeedback: int = 0
    ufeedback_init_sigma: float = 0.0
    num_randinit_ufactor: int = 0
    num_randinit_ifactor: int = 0
    common_latent_space: int = 0
    user_nonnegative: int = 0
    common_feedback_space: int = 0
    extend_flag: int = 0
    item_nonnegative: int = 0

    def set_param(self, name: str, val: str) -> None:
        f, i = float, int
        if name == "num_user":
            self.num_user = i(val)
        if name == "num_item":
            self.num_item = i(val)
        if name == "num_uiset":
            self.num_user = self.num_item = i(val)
        if name == "num_global":
            self.num_global = i(val)
        if name == "num_factor":
            self.num_factor = i(val)
        if name == "u_init_sigma":
            self.u_init_sigma = f(val)
        if name == "i_init_sigma":
            self.i_init_sigma = f(val)
        if name == "ui_init_sigma":
            self.u_init_sigma = self.i_init_sigma = f(val)
        if name == "base_score":
            self.base_score = f(val)
        if name == "no_user_bias":
            self.no_user_bias = i(val)
        if name == "num_ufeedback":
            self.num_ufeedback = i(val)
        if name == "num_randinit_ufactor":
            self.num_randinit_ufactor = i(val)
        if name == "num_randinit_ifactor":
            self.num_randinit_ifactor = i(val)
        if name == "num_randinit_uifactor":
            self.num_randinit_ufactor = self.num_randinit_ifactor = i(val)
        if name == "ufeedback_init_sigma":
            self.ufeedback_init_sigma = f(val)
        if name == "common_latent_space":
            self.common_latent_space = i(val)
        if name == "common_feedback_space":
            self.common_feedback_space = i(val)
        if name == "user_nonnegative":
            self.user_nonnegative = i(val)
        if name == "item_nonnegative":
            self.item_nonnegative = i(val)

    def to_bytes(self) -> bytes:
        rec = np.zeros((), dtype=_MODEL_PARAM_DTYPE)
        for name in _MODEL_PARAM_DTYPE.names:
            if name != "reserved":
                rec[name] = getattr(self, name)
        return rec.tobytes()

    @classmethod
    def from_bytes(cls, b: bytes) -> "SVDModelParam":
        rec = np.frombuffer(b[: _MODEL_PARAM_DTYPE.itemsize], dtype=_MODEL_PARAM_DTYPE)[0]
        p = cls()
        for name in _MODEL_PARAM_DTYPE.names:
            if name != "reserved":
                v = rec[name]
                setattr(p, name, float(v) if rec.dtype[name].kind == "f" else int(v))
        return p

    NBYTES = _MODEL_PARAM_DTYPE.itemsize


class ParameterSet:
    """Per-index-range weight decay (apex_svd_base.h:33-75).

    Config keys '<prefixA>bound' / '<prefixA>wd' (or prefixB) define ordered
    ranges: each 'bound' value b means indices up to b-1 use the wd given for
    that range; wd must be supplied for each range before its bound.
    """

    def __init__(self, prefix_a: str, prefix_b: str):
        self.prefix_a = prefix_a
        self.prefix_b = prefix_b
        self.bound: List[int] = []
        self.wd: List[float] = []

    def set_param(self, name: str, val: str) -> None:
        if name.startswith(self.prefix_a):
            name = name[len(self.prefix_a):]
        elif name.startswith(self.prefix_b):
            name = name[len(self.prefix_b):]
        else:
            return
        if name == "bound":
            bd = int(val)
            assert bd > 0, "can't give 0 as bound"
            assert not self.bound or self.bound[-1] < bd, "bound must be given in order"
            assert len(self.bound) + 1 == len(self.wd), "must specify wd in each range"
            self.bound.append(bd - 1)
        if name == "wd":
            assert len(self.wd) == len(self.bound), "setting must be exact"
            self.wd.append(float(val))

    def get_wd(self, gid: int, wd_default: float) -> float:
        if not self.bound:
            return wd_default
        idx = bisect.bisect_left(self.bound, gid)
        assert idx < len(self.bound), "bound set err"
        return self.wd[idx]

    def wd_table(self, n: int, wd_default: float) -> np.ndarray:
        """Densify to a per-index wd array of length n (for device use)."""
        out = np.full(n, wd_default, dtype=np.float32)
        if not self.bound:
            return out
        lo = 0
        for b, w in zip(self.bound, self.wd):
            out[lo : b + 1] = w
            lo = b + 1
        # indices beyond the last bound assert in the reference; leave default
        return out

    @property
    def empty(self) -> bool:
        return not self.bound
