// Code shared by the SGD kernels (fused_embed.cu, fused_svdpp.cu,
// fused_imfb.cu): the loss gradient of the gated active types, the decay
// factors of a row formed from the decay rates, the apply of a step's
// accumulated update to every touched row of the table by a grid's warps,
// the kernels' own clock, and the grid of a persistent cooperative launch.
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

// The decay factors of a row with touch counts (cu, ci), formed from the
// decay rates themselves:
//   fac   = exp(cu log(1 - lr wd_u[n]) + ci log(1 - lr wd_i[n]))
//   fac_b = exp(ci log(1 - lr wd_ib) (+ cu log(1 - lr wd_ub)))
// (log_bu, log_bi: the bias terms' logs, formed once per round).
struct RateDecay {
  const float* wd_u;
  const float* wd_i;
  float lr, log_bu, log_bi;
  int with_user_bias;
  __device__ __forceinline__ void operator()(int n, float cu, float ci, float* fac,
                                             float* fac_b) const {
    *fac = expf(cu * log1m_rate(lr, __ldg(wd_u + n)) + ci * log1m_rate(lr, __ldg(wd_i + n)));
    float sb = ci * log_bi;
    if (with_user_bias) sb += cu * log_bu;
    *fac_b = expf(sb);
  }
};

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

__device__ __forceinline__ long long now_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The kernels' own clock: block 0's first thread adds the time since its
// last stamp to trace[slot] (trace null: no clock)
struct PhaseClock {
  long long* trace;
  long long last;
  __device__ __forceinline__ void stamp(int slot) {
    if (trace == nullptr) return;
    const long long t = now_ns();
    trace[slot] += t - last;
    last = t;
  }
};

// The grid of a cooperative launch of ``kernel`` with ``threads`` threads
// and ``smem`` bytes of dynamic shared memory a block: one block per SM, if
// the device can co-schedule that (no fallback: otherwise the call is
// refused with cudaErrorCooperativeLaunchTooLarge).  Asked once per
// (kernel, device, threads, shared memory) and kept.
inline int cooperative_grid(const void* kernel, int threads, size_t smem, int* grid) {
  struct Kept {
    const void* kernel;
    int dev, threads;
    size_t smem;
    int grid;
  };
  constexpr int kKept = 8;
  static Kept kept[kKept];
  static int next = 0;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  for (const Kept& e : kept) {
    if (e.kernel == kernel && e.dev == dev && e.threads == threads && e.smem == smem) {
      *grid = e.grid;
      return 0;
    }
  }
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return (int)err;
  if (!coop || per_sm < 1 || sms < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  kept[next] = Kept{kernel, dev, threads, smem, sms};
  next = (next + 1) % kKept;
  *grid = sms;
  return 0;
}

// A cooperative launch of ``kernel(args)`` on the grid of cooperative_grid;
// the grid is written to ``grid_out``.  Returns the launch's error.
template <class Args>
int launch_cooperative(const void* kernel, const Args& args, int threads, size_t smem,
                       int* grid_out, cudaStream_t stream) {
  int grid = 0;
  const int refused = cooperative_grid(kernel, threads, smem, &grid);
  if (refused) return refused;
  *grid_out = grid;
  void* params[] = {(void*)&args};
  const cudaError_t err =
      cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(threads), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace sgd
