# Verbatim copy of svdfeature_tpu/utils/apex_random.py; tests/test_torch_data.py keeps the two identical.
"""Bit-exact port of the reference PRNG (apex_random).

The reference (apex-tensor/apex_random.h:40-121) delegates to the C
library's ``srand``/``rand`` and layers uniform/normal/shuffle on top.
On the linux hosts the reference binaries run on, ``rand()`` is glibc's
``random()``: the TYPE_3 additive-feedback generator (degree 31,
separation 3, 310 warm-up outputs discarded, output = state >> 1).

This module reproduces that generator exactly, so seeded trajectories
(model rand_init, pair sampling, shuffles) can be compared bit-for-bit
against the reference binaries in golden tests.  It is a *debugging /
golden-test* device: the production path uses numpy RandomState (fast,
vectorized); enable with config ``exact_rng=1``.

Verified against glibc by `tests/test_apex_random.py` (golden values
generated by compiling the apex_random formulas against the host libc).
"""

from __future__ import annotations

import math
from typing import List, Sequence

_MASK32 = 0xFFFFFFFF
RAND_MAX = 2147483647


class GlibcRand:
    """glibc random() — TYPE_3 additive feedback x[i] = x[i-3] + x[i-31]."""

    def __init__(self, seed: int = 1):
        self.seed(seed)

    def seed(self, seed: int) -> None:
        seed &= _MASK32
        if seed == 0:
            seed = 1
        r: List[int] = [0] * 31
        r[0] = seed
        word = seed
        for i in range(1, 31):
            # Park-Miller minstd via the hi/lo decomposition glibc uses
            hi, lo = divmod(word, 127773)
            word = (16807 * lo - 2836 * hi) % 2147483647
            r[i] = word
        self._r = r
        self._f = 3  # fptr - state
        self._p = 0  # rptr - state
        for _ in range(310):
            self.rand()

    def rand(self) -> int:
        r = self._r
        f, p = self._f, self._p
        val = (r[f] + r[p]) & _MASK32
        r[f] = val
        self._f = f + 1 if f < 30 else 0
        self._p = p + 1 if p < 30 else 0
        return val >> 1


class ApexRandom:
    """apex_random namespace functions over the exact glibc stream
    (apex_random.h:40-121)."""

    def __init__(self, seed: int = 1):
        self._g = GlibcRand(seed)

    def seed(self, seed: int) -> None:
        self._g.seed(seed)

    def rand(self) -> int:
        return self._g.rand()

    def next_double(self) -> float:
        """uniform [0,1) (apex_random.h:47-49)."""
        return self._g.rand() / (RAND_MAX + 1.0)

    def next_double2(self) -> float:
        """uniform (0,1) (apex_random.h:51-53)."""
        return (self._g.rand() + 1.0) / (RAND_MAX + 2.0)

    def next_uint32(self, n: int) -> int:
        """uniform integer in [0, n) (apex_random.h:63-65)."""
        return int(math.floor(self.next_double() * n))

    def sample_normal(self) -> float:
        """N(0,1) by polar Box-Muller rejection (apex_random.h:67-77)."""
        while True:
            x = 2.0 * self.next_double2() - 1.0
            y = 2.0 * self.next_double2() - 1.0
            s = x * x + y * y
            if not (s >= 1.0 or s == 0.0):
                return x * math.sqrt(-2.0 * math.log(s) / s)

    def sample_normal_ms(self, mu: float, sigma: float) -> float:
        return self.sample_normal() * sigma + mu

    def sample_binary(self, p: float) -> int:
        return 1 if self.next_double() < p else 0

    def shuffle(self, data) -> None:
        """In-place Fisher-Yates, reference order (apex_random.h:106-121):
        i from len-1 down to 1, swap with next_uint32(i+1)."""
        n = len(data)
        if n == 0:
            return
        for i in range(n - 1, 0, -1):
            j = self.next_uint32(i + 1)
            data[i], data[j] = data[j], data[i]

    def gaussian_array(self, shape: Sequence[int], sigma: float):
        """Row-major float32 tensor of sample_gaussian draws — the order
        tensor::sample_gaussian fills a CTensor
        (apex_tensor_cpu_inline_common.h:249-253).  The C expression is
        ``(TENSOR_FLOAT)apex_random::sample_normal() * sd``: the cast binds
        to sample_normal() first, so the multiply is float32 x float32."""
        import numpy as np

        total = 1
        for s in shape:
            total *= s
        sig32 = np.float32(sigma)
        out = np.empty(total, np.float32)
        for idx in range(total):
            out[idx] = np.float32(self.sample_normal()) * sig32
        return out.reshape(shape)
