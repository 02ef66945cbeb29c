// Batched SGD of the base solver on Hopper: a call of R rounds x T steps as
// one persistent cooperative launch, sgd_rounds, whose two phases a step
// (accumulate, apply) are separated by grid-wide barriers.
//
// Replaces the TPU kernel svdfeature_tpu/ops/pallas_embed.py::_make_kernel
// (launched by train_rounds_pallas), and computes what it computes: steps
// of single-feature user/item segments with eager L2 decay, the optional
// global linear segment, and the five gated active types, in f32 (the TPU
// kernel reads the table in bf16 by default).  Per step:
//   * accumulate: per example the gather of its two rows, the dot, the
//     error, and the scatter of [coef * p_other | coef | count_u | count_i]
//     into acc[N, k+3] with atomicAdd, so duplicate rows in a batch sum as
//     the reference's scatter-add; the global segment's [err v | v^2 |
//     count] per slot into gacc[NG, 3];
//   * apply: every touched row w = (w + dw) * exp(cu log(1 - lr wd_u) +
//     ci log(1 - lr wd_i)), its bias likewise (sgd::apply_touched_rows),
//     the accumulator cleared; block 0 also applies the damped global
//     update, g = (g + lr S / (1 + lr C2)) * exp(cg log(1 - lr wd_g)) (or
//     the plain g + lr S with exact_global), and clears gacc.
// The barrier between the phases puts every read of a batch before any
// write of it (the reference trajectory's batched-SGD semantics); the one
// after the apply puts every write before the next step's reads.
//
// What bounds it on the card: latency, not bytes or arithmetic.  At the
// ML-100K demos' shapes (N=2626, k=64, B=4096) the table (672 KB), its
// accumulator and a round's planes sit in L2; a step is about 4k flops an
// example, a fraction of a microsecond at the f32 rate, while its chain is
// a few L2 round trips (indices -> rows -> dot -> atomics | barrier |
// counts -> rows | barrier).  What the design does about it:
//   * one launch per call: no host work and no launch boundary between
//     steps, whose card time (7-9 us) is less than the host cost of the
//     two launches a step would take;
//     the decay logs are formed in the kernel from the learning rate and
//     the decay rates;
//   * a grid of one block per SM, 16 warps each, and half a warp per
//     example, so that at B=4096 each half-warp has at most one example a
//     step (every row load of a step is in flight at once) and keeps its
//     p_u / p_i in registers between the dot and the scatter;
//   * the global segment's sums go to shared memory first (NG <= 1024
//     slots, 12 KB) and then into gacc with one atomic per touched slot
//     per block: one atomic per entry per example would put 12,288 a step
//     on neighborhoodModel's 21 addresses;
//   * slots of the dummy row N-1 (padding) and of the dummy global slot
//     scatter nothing: both are exactly 0 and stay so (the dummy row is
//     zeroed at the start of the call, the dummy slot at every update).
//
// Plain C interface (ctypes, svdfeature_tpu_torch/ops/_build.py): the entry
// point launches on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() or the error of the call that
// failed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sgd_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kExLanes = 16;  // lanes per example: two examples a warp at once
constexpr int kCols = 8;      // columns per lane kept in registers (k <= 128)
constexpr int kMaxGlobalSlots = 1024;

struct EmbedRounds {
  // the tables (updated in place) and the call's scratch, all written
  // during the launch: never read through the read-only path
  float *w, *b, *g, *acc, *gacc;
  // inputs, read only
  const int *u_idx, *i_idx, *g_idx;
  const float *u_val, *i_val, *label, *weight, *g_val;
  const float *lrs, *wd_u, *wd_i, *wd_g, *wd_ub, *wd_ib;
  // null, or 4 sums of nanoseconds as block 0's first thread sees them: its
  // own work in the accumulate and apply phases [0, 1], then the barrier
  // after each [2, 3] (which waits for the slowest block)
  long long* trace;
  int N, k, NG, SG, B, T, R, active_type, with_user_bias, exact_global;
  float base_score;
};

// Example x by the kExLanes lanes of a half-warp (``sl`` its lane in the
// half, ``mask`` the half's lanes); the global sums go to shared memory
// ``s_g`` [NG][3].
__device__ __forceinline__ void accumulate_example(const EmbedRounds& a, int64_t x, float lr,
                                                   int sl, unsigned mask, float* s_g) {
  const int N = a.N, k = a.k, SG = a.SG;
  const int u = __ldg(a.u_idx + x);
  const int it = __ldg(a.i_idx + x);
  const float uv = __ldg(a.u_val + x);
  const float iv = __ldg(a.i_val + x);
  const float* wu = a.w + (int64_t)u * k;
  const float* wi = a.w + (int64_t)it * k;

  float pu_r[kCols], pi_r[kCols];
  float dot = 0.0f;
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const int c = sl + kExLanes * q;
    pu_r[q] = 0.0f;
    pi_r[q] = 0.0f;
    if (c < k) {
      pu_r[q] = uv * wu[c];
      pi_r[q] = iv * wi[c];
      dot += pu_r[q] * pi_r[q];
    }
  }
  for (int c = sl + kExLanes * kCols; c < k; c += kExLanes) dot += (uv * wu[c]) * (iv * wi[c]);
#pragma unroll
  for (int o = kExLanes / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(mask, dot, o, kExLanes);

  // every lane of the half forms the same score, in the plain version's order
  float score = a.base_score;
  if (SG > 0) {
    float gsum = 0.0f;
    for (int s = 0; s < SG; ++s) gsum += __ldg(a.g_val + x * SG + s) * a.g[__ldg(a.g_idx + x * SG + s)];
    score += gsum;
  }
  score += iv * a.b[it];
  if (a.with_user_bias) score += uv * a.b[u];
  score += dot;
  const float err = sgd::active_grad(score, __ldg(a.label + x), a.active_type) * __ldg(a.weight + x);
  const float lr_err = lr * err;
  const float coef_u = lr_err * uv;
  const float coef_i = lr_err * iv;

  const int ld = k + 3;
  float* au = a.acc + (int64_t)u * ld;
  float* ai = a.acc + (int64_t)it * ld;
  const bool real_u = u != N - 1, real_i = it != N - 1;
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const int c = sl + kExLanes * q;
    if (c < k) {
      if (real_u) atomicAdd(au + c, coef_u * pi_r[q]);
      if (real_i) atomicAdd(ai + c, coef_i * pu_r[q]);
    }
  }
  for (int c = sl + kExLanes * kCols; c < k; c += kExLanes) {
    if (real_u) atomicAdd(au + c, coef_u * (iv * wi[c]));
    if (real_i) atomicAdd(ai + c, coef_i * (uv * wu[c]));
  }
  if (sl == 0) {
    if (real_u) {
      if (a.with_user_bias) atomicAdd(au + k, coef_u);
      atomicAdd(au + k + 1, 1.0f);
    }
    if (real_i) {
      atomicAdd(ai + k, coef_i);
      atomicAdd(ai + k + 2, 1.0f);
    }
  }
  if (sl < SG) {
    const int gi = __ldg(a.g_idx + x * SG + sl);
    const float gv = __ldg(a.g_val + x * SG + sl);
    if (gi != a.NG - 1) {
      atomicAdd(s_g + 3 * gi, err * gv);
      atomicAdd(s_g + 3 * gi + 1, gv * gv);
      atomicAdd(s_g + 3 * gi + 2, 1.0f);
    }
  }
}

// The damped global update (update_no_decay, then the touch-count decay)
// of every slot by the threads of one block; clears gacc.  The dummy slot
// stays 0.
__device__ __forceinline__ void update_globals(const EmbedRounds& a, float lr) {
  for (int j = threadIdx.x; j < a.NG; j += blockDim.x) {
    float* ga = a.gacc + 3 * j;
    const float S = ga[0];
    const float C2 = ga[1];
    const float cnt = ga[2];
    float gv = a.g[j];
    gv = a.exact_global ? gv + lr * S : gv + lr * S / (1.0f + lr * C2);
    gv *= expf(cnt * sgd::log1m_rate(lr, __ldg(a.wd_g + j)));
    a.g[j] = (j == a.NG - 1) ? 0.0f : gv;
    ga[0] = 0.0f;
    ga[1] = 0.0f;
    ga[2] = 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads) sgd_rounds_kernel(const EmbedRounds a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float s_g[];  // [NG][3] when the global segment is on
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int bid = blockIdx.x, nblocks = gridDim.x;
  const int gwarp = bid * nw + warp, nwarps = nblocks * nw;
  const int half = lane / kExLanes, sl = lane % kExLanes;
  const unsigned mask = ((1u << kExLanes) - 1u) << (half * kExLanes);
  const int gex = gwarp * (32 / kExLanes) + half, nex = nwarps * (32 / kExLanes);
  const int N = a.N, k = a.k, B = a.B;
  const bool with_g = a.SG > 0;

  // the dummy row stays exactly 0 (padding scatters nothing into it); only
  // padding examples, of weight 0, read it
  if (bid == 0) {
    for (int j = threadIdx.x; j < k; j += blockDim.x) a.w[(int64_t)(N - 1) * k + j] = 0.0f;
    if (threadIdx.x == 0) a.b[N - 1] = 0.0f;
  }
  if (with_g) {
    for (int j = threadIdx.x; j < 3 * a.NG; j += blockDim.x) s_g[j] = 0.0f;
  }
  __syncthreads();
  sgd::PhaseClock clock{bid == 0 && threadIdx.x == 0 ? a.trace : nullptr, 0};
  if (clock.trace != nullptr) clock.last = sgd::now_ns();

  for (int r = 0; r < a.R; ++r) {
    const float lr = __ldg(a.lrs + r);
    const sgd::RateDecay decay{a.wd_u, a.wd_i, lr, sgd::log1m_rate(lr, __ldg(a.wd_ub)),
                               sgd::log1m_rate(lr, __ldg(a.wd_ib)), a.with_user_bias};
    for (int t = 0; t < a.T; ++t) {
      // accumulate: every read of w, b and g
      for (int e = gex; e < B; e += nex) accumulate_example(a, (int64_t)t * B + e, lr, sl, mask, s_g);
      if (with_g) {  // the block's global sums, one atomic per touched slot
        __syncthreads();
        for (int j = threadIdx.x; j < a.NG; j += blockDim.x) {
          float* s = s_g + 3 * j;
          if (s[2] != 0.0f) {
            atomicAdd(a.gacc + 3 * j, s[0]);
            atomicAdd(a.gacc + 3 * j + 1, s[1]);
            atomicAdd(a.gacc + 3 * j + 2, s[2]);
            s[0] = 0.0f;
            s[1] = 0.0f;
            s[2] = 0.0f;
          }
        }
      }
      clock.stamp(0);
      grid.sync();
      clock.stamp(2);
      // apply: every write
      if (bid == 0 && with_g) update_globals(a, lr);
      sgd::apply_touched_rows(a.w, a.b, a.acc, N, k, gwarp, nwarps, lane, decay);
      clock.stamp(1);
      grid.sync();
      clock.stamp(3);
    }
  }
}

}  // namespace

// R rounds x T steps in one cooperative launch.  ``ptrs`` holds the 20
// pointers of EmbedRounds in its order (the last, trace, may be null),
// ``ints`` its 10 ints, ``floats`` its 1 float; the grid (one block per
// SM) is written to ``grid_out``.
extern "C" int sgd_rounds(void* const* ptrs, const int* ints, const float* floats, int* grid_out,
                          void* stream) {
  EmbedRounds a;
  a.w = (float*)ptrs[0];
  a.b = (float*)ptrs[1];
  a.g = (float*)ptrs[2];
  a.acc = (float*)ptrs[3];
  a.gacc = (float*)ptrs[4];
  a.u_idx = (const int*)ptrs[5];
  a.i_idx = (const int*)ptrs[6];
  a.g_idx = (const int*)ptrs[7];
  a.u_val = (const float*)ptrs[8];
  a.i_val = (const float*)ptrs[9];
  a.label = (const float*)ptrs[10];
  a.weight = (const float*)ptrs[11];
  a.g_val = (const float*)ptrs[12];
  a.lrs = (const float*)ptrs[13];
  a.wd_u = (const float*)ptrs[14];
  a.wd_i = (const float*)ptrs[15];
  a.wd_g = (const float*)ptrs[16];
  a.wd_ub = (const float*)ptrs[17];
  a.wd_ib = (const float*)ptrs[18];
  a.trace = (long long*)ptrs[19];
  a.N = ints[0];
  a.k = ints[1];
  a.NG = ints[2];
  a.SG = ints[3];
  a.B = ints[4];
  a.T = ints[5];
  a.R = ints[6];
  a.active_type = ints[7];
  a.with_user_bias = ints[8];
  a.exact_global = ints[9];
  a.base_score = floats[0];
  if (a.N < 1 || a.k < 1 || a.B < 1 || a.T < 1 || a.R < 1 || a.NG < 1 || a.SG < 0 ||
      a.SG > kExLanes || (a.SG > 0 && a.NG > kMaxGlobalSlots))
    return (int)cudaErrorInvalidValue;
  const size_t smem = a.SG > 0 ? sizeof(float) * 3 * a.NG : 0;  // at most 12 KB
  return sgd::launch_cooperative((const void*)sgd_rounds_kernel, a, kThreads, smem, grid_out,
                                 (cudaStream_t)stream);
}
