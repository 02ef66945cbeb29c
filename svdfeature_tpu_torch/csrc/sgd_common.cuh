// Device code shared by the SGD kernels (fused_embed.cu, fused_svdpp.cu):
// the loss gradient of the gated active types and the per-row apply of a
// step's accumulated update with its touch-count decay (one row, or every
// touched row of the table by a grid's warps).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sgd {

// losses.py: 1 / (1 + exp(-x)), full-precision expf
__device__ __forceinline__ float sigmoid_ref(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// cal_grad(label, map_active(score)) of the kernels' active types
// (losses.py; the gates admit 0, 1, 2, 3 and 7 only)
__device__ __forceinline__ float active_grad(float score, float label, int active_type) {
  switch (active_type) {
    case 1: {  // SIGMOID_L2
      const float p = sigmoid_ref(score);
      return (label - p) * p * (1.0f - p);
    }
    case 2:  // SIGMOID_LIKELIHOOD: pred = sigmoid(score), grad = r - pred
    case 3:  // SIGMOID_RANK: pred = score, grad = r - sigmoid(pred)
    case 7:  // SIGMOID_QSGRAD: as SIGMOID_RANK
      return label - sigmoid_ref(score);
    default:  // LINEAR
      return label - score;
  }
}

// log(1 - x) of a decay rate, as the wrappers' _log1m forms it in f32: the
// product and the difference rounded separately (no fused multiply-add),
// clamped at a tiny positive so lr*wd == 1 decays to exactly 0
__device__ __forceinline__ float log1m_rate(float lr, float wd) {
  return logf(fmaxf(__fsub_rn(1.0f, __fmul_rn(lr, wd)), 1e-38f));
}

// One warp applies row n of a step's accumulator, a = acc + n (k+3) =
// [dw | db | cu | ci], with its decay factors already formed, and clears it:
//   w[n] = (w[n] + dw) * fac,  b[n] = (b[n] + db) * fac_b
// The dummy row is written as exact zeros.  The caller's lanes have all read
// the counts before this is entered.
__device__ __forceinline__ void apply_row_scaled(float* w, float* b, float* a, float fac,
                                                 float fac_b, bool dummy, int k, int n,
                                                 int lane) {
  float* wn = w + (int64_t)n * k;
  for (int c = lane; c < k; c += 32) {
    wn[c] = dummy ? 0.0f : (wn[c] + a[c]) * fac;
    a[c] = 0.0f;
  }
  __syncwarp();  // every lane has read the counts before lane 0 clears them
  if (lane == 0) {
    b[n] = dummy ? 0.0f : (b[n] + a[k]) * fac_b;
    a[k] = 0.0f;
    a[k + 1] = 0.0f;
    a[k + 2] = 0.0f;
  }
}

// The decay factors of a row with touch counts (cu, ci) from the per-round
// log tables (log_u / log_i [R, N], log_bu / log_bi [R]):
//   fac   = exp(cu log(1 - lr wd_u[n]) + ci log(1 - lr wd_i[n]))
//   fac_b = exp(ci log(1 - lr wd_ib) (+ cu log(1 - lr wd_ub)))
struct TableDecay {
  const float* log_u;
  const float* log_i;
  const float* log_bu;
  const float* log_bi;
  int N, r, with_user_bias;
  __device__ __forceinline__ void operator()(int n, float cu, float ci, float* fac,
                                             float* fac_b) const {
    *fac = expf(cu * log_u[(int64_t)r * N + n] + ci * log_i[(int64_t)r * N + n]);
    float sb = ci * log_bi[r];
    if (with_user_bias) sb += cu * log_bu[r];
    *fac_b = expf(sb);
  }
};

// One warp applies row n of a step's accumulator acc[N, k+3] =
// [dw | db | cu | ci] to the tables and clears it:
//   w[n] = (w[n] + dw) * exp(cu log(1 - lr wd_u[n]) + ci log(1 - lr wd_i[n]))
//   b[n] = (b[n] + db) * exp(ci log(1 - lr wd_ib) (+ cu log(1 - lr wd_ub)))
// A row no example touched is left alone (its update is exactly the
// identity); the dummy row N-1 is written as exact zeros.
__device__ __forceinline__ void apply_row(
    float* __restrict__ w, float* __restrict__ b, float* __restrict__ acc,
    const float* __restrict__ log_u, const float* __restrict__ log_i,
    const float* __restrict__ log_bu, const float* __restrict__ log_bi, int N,
    int k, int r, int with_user_bias, int n, int lane) {
  float* a = acc + (int64_t)n * (k + 3);
  const float cu = a[k + 1];
  const float ci = a[k + 2];
  if (cu == 0.0f && ci == 0.0f) return;
  float fac, fac_b;
  TableDecay{log_u, log_i, log_bu, log_bi, N, r, with_user_bias}(n, cu, ci, &fac, &fac_b);
  apply_row_scaled(w, b, a, fac, fac_b, n == N - 1, k, n, lane);
}

// Every touched row of acc[N, k+3] applied and cleared by the warps
// [gwarp, nwarps) of a grid: each lane reads the counts of one row (rows
// strided so that a warp's rows spread over the table), a ballot finds the
// touched ones, and the warp applies them four at a time, the loads of all
// four started before the first store, with the factors that
// ``decay(n, cu, ci, &fac, &fac_b)`` forms.  One round trip for the counts
// of 32 rows and one for the data of four, instead of two per row.
template <class Decay>
__device__ __forceinline__ void apply_touched_rows(float* w, float* b, float* acc, int N, int k,
                                                   int gwarp, int nwarps, int lane,
                                                   const Decay& decay) {
  constexpr int kBatch = 4;
  const int ld = k + 3;
  for (int base = 0; base < N; base += 32 * nwarps) {
    const int n = base + lane * nwarps + gwarp;
    float cu = 0.0f, ci = 0.0f;
    if (n < N) {
      cu = acc[(int64_t)n * ld + k + 1];
      ci = acc[(int64_t)n * ld + k + 2];
    }
    // warp-uniform from here on: the counts travel by shuffle
    unsigned touched = __ballot_sync(0xffffffffu, cu != 0.0f || ci != 0.0f);
    while (touched) {
      int rn[kBatch];
      float fac[kBatch], fac_b[kBatch];
      bool live[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        live[i] = touched != 0;
        const int src = live[i] ? __ffs(touched) - 1 : 0;
        touched &= touched - 1;  // 0 stays 0
        const float rcu = __shfl_sync(0xffffffffu, cu, src);
        const float rci = __shfl_sync(0xffffffffu, ci, src);
        rn[i] = base + src * nwarps + gwarp;
        fac[i] = 0.0f;
        fac_b[i] = 0.0f;
        if (live[i]) decay(rn[i], rcu, rci, &fac[i], &fac_b[i]);
      }
      for (int c = lane; c < k; c += 32) {
        float wv[kBatch], av[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          if (live[i]) {
            wv[i] = w[(int64_t)rn[i] * k + c];
            av[i] = acc[(int64_t)rn[i] * ld + c];
          }
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          if (live[i]) {
            w[(int64_t)rn[i] * k + c] = rn[i] == N - 1 ? 0.0f : (wv[i] + av[i]) * fac[i];
            acc[(int64_t)rn[i] * ld + c] = 0.0f;
          }
        }
      }
      if (lane == 0) {
        float bv[kBatch], dbv[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          if (live[i]) {
            bv[i] = b[rn[i]];
            dbv[i] = acc[(int64_t)rn[i] * ld + k];
          }
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          if (live[i]) {
            float* a = acc + (int64_t)rn[i] * ld;
            b[rn[i]] = rn[i] == N - 1 ? 0.0f : (bv[i] + dbv[i]) * fac_b[i];
            a[k] = 0.0f;
            a[k + 1] = 0.0f;
            a[k + 2] = 0.0f;
          }
        }
      }
    }
  }
}

}  // namespace sgd
