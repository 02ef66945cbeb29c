// Device code shared by the SGD kernels (fused_embed.cu, fused_svdpp.cu):
// the loss gradient of the gated active types and the per-row apply of a
// step's accumulated update with its touch-count decay.
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
  const bool dummy = (n == N - 1);
  const float fac = expf(cu * log_u[(int64_t)r * N + n] + ci * log_i[(int64_t)r * N + n]);
  float* wn = w + (int64_t)n * k;
  for (int c = lane; c < k; c += 32) {
    wn[c] = dummy ? 0.0f : (wn[c] + a[c]) * fac;
    a[c] = 0.0f;
  }
  __syncwarp();  // every lane has read the counts before lane 0 clears them
  if (lane == 0) {
    float sb = ci * log_bi[r];
    if (with_user_bias) sb += cu * log_bu[r];
    b[n] = dummy ? 0.0f : (b[n] + a[k]) * expf(sb);
    a[k] = 0.0f;
    a[k + 1] = 0.0f;
    a[k + 2] = 0.0f;
  }
}

}  // namespace sgd
