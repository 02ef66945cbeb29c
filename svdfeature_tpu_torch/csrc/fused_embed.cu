// Batched SGD of the base solver on Hopper: gather -> per-example dot ->
// atomic scatter -> per-row decay, two launches per training step.
//
// Replaces the TPU kernel svdfeature_tpu/ops/pallas_embed.py::_make_kernel
// (launched by train_rounds_pallas), and computes what it computes: one
// step of single-feature user/item segments with eager L2 decay, the
// optional global linear segment, and the five gated active types.
//
// What bounds it on the card: not arithmetic (about 4k flops per example)
// but L2 traffic and atomics.  The ML-100K table (2626 x 64 f32, 672 KB)
// and its accumulator sit in the 50 MB L2 for the whole run; each step
// gathers 2 rows per example and issues 2(k+2) f32 atomics per example
// into acc[N, k+3].  The design keeps that traffic minimal and simple:
//   * sgd_accumulate: one warp per example.  Lanes stride the k factor
//     columns, so a row is read as coalesced 128-byte lines; the dot
//     product is a warp-shuffle reduction; every lane derives the error
//     from the reduced score and scatters its own columns of
//     [coef * p_other | coef | count_u | count_i] with atomicAdd, so
//     duplicate rows in a batch sum exactly as the reference's scatter-add.
//   * sgd_apply: one warp per table row (sgd::apply_row, sgd_common.cuh);
//     rows no example touched are left alone (their update is exactly the
//     identity), touched rows get
//     w = (w + dw) * exp(cu * log(1 - lr wd_u) + ci * log(1 - lr wd_i)),
//     the bias its decay, and the accumulator is zeroed for the next step.
//     Block 0 also applies the damped global update.
// Splitting the step into two launches puts every read of a batch before
// any write of it (the reference trajectory's batched-SGD semantics); the
// dummy row N-1 and dummy global slot NG-1 are written as exact zeros.
//
// Plain C interface (ctypes, svdfeature_tpu_torch/ops/_build.py): each entry
// point launches on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "sgd_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

__global__ void __launch_bounds__(kThreads) sgd_accumulate_kernel(
    const float* __restrict__ w, const float* __restrict__ b,
    const float* __restrict__ g, const int* __restrict__ u_idx,
    const float* __restrict__ u_val, const int* __restrict__ i_idx,
    const float* __restrict__ i_val, const float* __restrict__ label,
    const float* __restrict__ weight, const int* __restrict__ g_idx,
    const float* __restrict__ g_val, const float* __restrict__ lrs,
    float* __restrict__ acc, float* __restrict__ gacc, int k, int B, int SG,
    int t, int r, int active_type, int with_user_bias, float base_score) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (e >= B) return;
  const int64_t x = (int64_t)t * B + e;
  const int u = u_idx[x];
  const int it = i_idx[x];
  const float uv = u_val[x];
  const float iv = i_val[x];
  const float* wu = w + (int64_t)u * k;
  const float* wi = w + (int64_t)it * k;

  float dot = 0.0f;
  for (int c = lane; c < k; c += 32) dot += (uv * wu[c]) * (iv * wi[c]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);

  // every lane forms the same score, in the plain version's order
  float score = base_score;
  if (SG > 0) {
    float gsum = 0.0f;
    for (int s = 0; s < SG; ++s) gsum += g_val[x * SG + s] * g[g_idx[x * SG + s]];
    score += gsum;
  }
  score += iv * b[it];
  if (with_user_bias) score += uv * b[u];
  score += dot;
  const float err = sgd::active_grad(score, label[x], active_type) * weight[x];
  const float lr_err = lrs[r] * err;
  const float coef_u = lr_err * uv;
  const float coef_i = lr_err * iv;

  const int ld = k + 3;
  float* au = acc + (int64_t)u * ld;
  float* ai = acc + (int64_t)it * ld;
  for (int c = lane; c < k; c += 32) {
    atomicAdd(au + c, coef_u * (iv * wi[c]));
    atomicAdd(ai + c, coef_i * (uv * wu[c]));
  }
  if (lane == 0) {
    if (with_user_bias) atomicAdd(au + k, coef_u);
    atomicAdd(au + k + 1, 1.0f);
    atomicAdd(ai + k, coef_i);
    atomicAdd(ai + k + 2, 1.0f);
  }
  if (lane < SG) {
    const int gi = g_idx[x * SG + lane];
    const float gv = g_val[x * SG + lane];
    atomicAdd(gacc + 3 * gi, err * gv);
    atomicAdd(gacc + 3 * gi + 1, gv * gv);
    atomicAdd(gacc + 3 * gi + 2, 1.0f);
  }
}

__global__ void __launch_bounds__(kThreads) sgd_apply_kernel(
    float* __restrict__ w, float* __restrict__ b, float* __restrict__ g,
    float* __restrict__ acc, float* __restrict__ gacc,
    const float* __restrict__ lrs, const float* __restrict__ log_u,
    const float* __restrict__ log_i, const float* __restrict__ log_g,
    const float* __restrict__ log_bu, const float* __restrict__ log_bi, int N,
    int k, int NG, int r, int with_user_bias, int exact_global) {
  if (blockIdx.x == 0) {
    // global linear segment (NG = 0 when absent): damped update_no_decay,
    // then touch-count decay; the dummy slot stays 0
    const float lr = lrs[r];
    for (int j = threadIdx.x; j < NG; j += blockDim.x) {
      float* ga = gacc + 3 * j;
      const float S = ga[0];
      const float C2 = ga[1];
      const float cg = ga[2];
      float gv = g[j];
      gv = exact_global ? gv + lr * S : gv + lr * S / (1.0f + lr * C2);
      gv *= expf(cg * log_g[(int64_t)r * NG + j]);
      g[j] = (j == NG - 1) ? 0.0f : gv;
      ga[0] = 0.0f;
      ga[1] = 0.0f;
      ga[2] = 0.0f;
    }
  }
  const int n = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (n >= N) return;
  sgd::apply_row(w, b, acc, log_u, log_i, log_bu, log_bi, N, k, r, with_user_bias, n,
                 threadIdx.x & 31);
}

}  // namespace

extern "C" int sgd_accumulate(const float* w, const float* b, const float* g,
                              const int* u_idx, const float* u_val,
                              const int* i_idx, const float* i_val,
                              const float* label, const float* weight,
                              const int* g_idx, const float* g_val,
                              const float* lrs, float* acc, float* gacc, int k,
                              int B, int SG, int t, int r, int active_type,
                              int with_user_bias, float base_score,
                              void* stream) {
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sgd_accumulate_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      w, b, g, u_idx, u_val, i_idx, i_val, label, weight, g_idx, g_val, lrs,
      acc, gacc, k, B, SG, t, r, active_type, with_user_bias, base_score);
  return (int)cudaGetLastError();
}

extern "C" int sgd_apply(float* w, float* b, float* g, float* acc, float* gacc,
                         const float* lrs, const float* log_u,
                         const float* log_i, const float* log_g,
                         const float* log_bu, const float* log_bi, int N, int k,
                         int NG, int r, int with_user_bias, int exact_global,
                         void* stream) {
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sgd_apply_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      w, b, g, acc, gacc, lrs, log_u, log_i, log_g, log_bu, log_bi, N, k, NG,
      r, with_user_bias, exact_global);
  return (int)cudaGetLastError();
}
