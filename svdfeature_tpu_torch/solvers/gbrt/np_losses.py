"""The loss functions the GBRT trainers call, in numpy, rounding as the JAX
package's do when its trainers call them.

The JAX trainers call the jnp ``losses`` module (svdfeature_tpu/losses.py)
on numpy arrays and Python scalars with 64-bit mode off.  A branch that
reaches a jnp function returns float32, computed by XLA on the CPU; a
branch of plain arithmetic stays numpy in its input's dtype (float64
arrays in RegGBRT, float64 scalars in APLambda's pairs).  So:

* ``map_active``: the sigmoids (types 1, 2) give float32; every other type
  is the identity;
* ``cal_grad``: types 0, 1, 2 stay in the input's dtype; 3, 5, 6, 7 give
  float32;
* ``cal_sgrad``: types 0, 3, 5, 6, 7 give float32; type 2 stays in the
  input's dtype; type 1 raises ``ValueError``.

The float32 branches are computed here in float32 with XLA's CPU
arithmetic: its exp is the Cephes polynomial evaluated with fused
multiply-adds (``exp32``), and results below the smallest normal float32
are flushed to zero.  The port's torch ``losses`` computes in its input's
dtype, so it would give float64 where the JAX trainers see float32.
"""

from __future__ import annotations

import numpy as np

LINEAR = 0
SIGMOID_L2 = 1
SIGMOID_LIKELIHOOD = 2
SIGMOID_RANK = 3
HINGE_SMOOTH = 5
HINGE_L2 = 6
SIGMOID_QSGRAD = 7

_F = np.float32
_TINY = np.finfo(np.float32).tiny


def _ftz(a):
    """Flush float32 results below the smallest normal to zero."""
    return np.where(np.abs(a) < _TINY, _F(0), a).astype(np.float32)


def _fma(a, b, c):
    """a * b + c on float32 arrays, rounded once to float32.  The product is
    exact in float64; the sum's float64 rounding error ``t`` breaks the tie
    that a second rounding to float32 would otherwise break to even."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bb = s - p
    t = (p - (s - bb)) + (c64 - bb)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    other = np.nextafter(r, np.where(s > r64, _F(np.inf), _F(-np.inf))).astype(np.float32)
    tie = (t != 0) & (s != r64) & (np.abs(s - r64) == np.abs(other.astype(np.float64) - s))
    return np.where(tie & ((t > 0) == (other.astype(np.float64) > r64)), other, r)


def exp32(x) -> np.ndarray:
    """float32 exp as XLA computes it on the CPU: x = n log 2 + a with
    n = floor(x log2 e + 1/2) in [-127, 127], e^a by Cephes' degree-6
    polynomial, times 2^n; the input clamped to [-87.8, 88.8]."""
    x = np.clip(np.asarray(x, np.float32), _F(-87.8), _F(88.8))

    def full(v):
        return np.full(x.shape, _F(v))

    n = np.clip(np.floor(_fma(x, full(1.44269504088896341), full(0.5))), _F(-127), _F(127))
    a = _fma(n, full(-0.693359375), x)
    a = _fma(n, full(2.12194440e-4), a)
    z = _fma(a, full(1.9875691500e-4), full(1.3981999507e-3))
    for c in (8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1):
        z = _fma(z, a, full(c))
    z = _F(1) + _fma(z, a * a, a)
    pow2 = ((n.astype(np.int32) + 127) << 23).view(np.float32)
    with np.errstate(over="ignore"):
        return _ftz(z * pow2)


def _f32(x):
    return np.asarray(x, np.float32)


def _sigmoid(x) -> np.ndarray:
    """jnp ``1 / (1 + exp(-x))`` on a numpy or Python input: -x in the
    input's dtype, the rest in float32."""
    return _ftz(_F(1) / (_F(1) + exp32(_f32(-np.asarray(x)))))


def map_active(s, atype: int):
    """Activation applied to the raw score (apex_svd_model.h:112-123)."""
    if atype in (SIGMOID_L2, SIGMOID_LIKELIHOOD):
        return _sigmoid(s)
    if atype in (LINEAR, SIGMOID_RANK, HINGE_SMOOTH, HINGE_L2, SIGMOID_QSGRAD):
        return s
    raise ValueError(f"unknown active type {atype}")


def _smooth_hinge_grad(z):
    """jnp.clip(1 - z, 0, 1): 1 - z in the input's dtype, the clip in float32."""
    return np.clip(_ftz(_f32(1.0 - z)), _F(0), _F(1))


def cal_grad(r, pred, atype: int):
    """Gradient of the objective to *maximize* (apex_svd_model.h:132-156)."""
    if atype == LINEAR:
        return r - pred
    if atype == SIGMOID_L2:
        return (r - pred) * pred * (1.0 - pred)
    if atype == SIGMOID_LIKELIHOOD:
        return r - pred
    if atype in (SIGMOID_QSGRAD, SIGMOID_RANK):
        return _ftz(_f32(r) - _sigmoid(pred))
    if atype == HINGE_SMOOTH:
        return np.where(np.asarray(r) > 0.5, _smooth_hinge_grad(pred - 0.5),
                        -_smooth_hinge_grad(0.5 - pred)).astype(np.float32)
    if atype == HINGE_L2:
        pred_a, r_a = np.asarray(pred), np.asarray(r)
        diff = _f32(r - pred)
        return np.where(r_a > 0.5, np.where(pred_a > 1.0, _F(0), diff),
                        np.where(pred_a < 0.0, _F(0), diff)).astype(np.float32)
    raise ValueError(f"unknown active type {atype}")


def cal_sgrad(r, pred, atype: int):
    """Second-order gradient (apex_svd_model.h:200-213)."""
    if atype in (LINEAR, HINGE_SMOOTH, HINGE_L2):
        return np.full(np.shape(pred), _F(-1.0))
    if atype == SIGMOID_LIKELIHOOD:
        return -pred * (1.0 - pred)
    if atype == SIGMOID_RANK:
        p = _sigmoid(pred)
        return _ftz(-p * (_F(1) - p))
    if atype == SIGMOID_QSGRAD:
        return np.full(np.shape(pred), _F(-0.25))
    raise ValueError(f"unknown second order gradient for active type {atype}")
