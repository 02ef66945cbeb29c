// The tile-sweep update of the big-table route on Hopper (K4): sum each
// touched row's run of payload entries and apply the step's regularization
// to that row, in place, one launch per training step.
//
// Replaces the TPU kernel svdfeature_tpu/ops/tile_sweep.py
// ::_make_sweep_kernel (launched by sweep_update) and computes what it
// computes.  The TPU kernel walks the pack-time plan cell by cell in tile
// order, lands a cell's [1024, W] payload on its [2048, W] tile with a
// one-hot MXU matmul (Mosaic has no row gather), accumulates the tile in
// VMEM scratch and applies the math on the tile's last visit.  On the H100
// a 2048 x 128 f32 tile is 1 MiB against 227 KB of shared memory per
// block, and the one-hot product only ever stood in for a gather, so the
// design is a segmented reduction instead:
//   * make_sweep_plan sorts entries stably by row and groups them by
//     tile, so each touched row's entries are one contiguous run of plan
//     positions; the runs' starts are found once at pack time
//     (ops/tile_sweep.attach_sweep_runs), as the plan is static.
//   * one warp per run: lanes stride the k+3 payload columns
//     [dw(k) | db | cu | ci] and sum the run's entries in plan order
//     (deterministic, no atomics), reading payload[src[p]] through the
//     plan instead of a materialized plan-ordered copy (1.4 GB per step
//     at bigTable on the TPU path); padding slots (src == E) add nothing.
//   * the warp then applies the last-visit math (reg_method 0-5, the lazy
//     modes through the int32 ref bits, the nonnegative clamps, the bias
//     decay) and writes the row.  Rows no entry touches are left alone:
//     the TPU kernel rewrites them unchanged.
// What bounds it on the card: bytes.  A step reads the payload (E rows of
// k+3 floats), the plan and each touched row once and writes each touched
// row once; the arithmetic is a handful of operations per column.
//
// The ref column holds int32 sample counts as raw bits; below 2^23 those
// bits are denormal floats, so they are only ever moved as ints here (and
// the build keeps denormals: no -ftz / fast math).
//
// Plain C interface (ctypes, svdfeature_tpu_torch/ops/_build.py): each entry
// point launches on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kChunks = 8;  // payload columns k+3 <= 32 * kChunks
constexpr unsigned kFull = 0xffffffffu;

// tile_sweep.py _log1m: clamp so lr*wd == 1 decays to exactly 0
__device__ __forceinline__ float log1m(float v) { return logf(fmaxf(1.0f - v, 1e-38f)); }

// sign(w) * max(|w| - lam, 0)
__device__ __forceinline__ float soft(float w, float lam) {
  const float m = fmaxf(fabsf(w) - lam, 0.0f);
  return w > 0.0f ? m : (w < 0.0f ? -m : 0.0f);
}

// column c of a warp's chunked row (chunk q holds column 32 q + lane)
__device__ __forceinline__ float column(const float (&a)[kChunks], int c) {
  float v = 0.0f;
#pragma unroll
  for (int q = 0; q < kChunks; ++q)
    if (q == (c >> 5)) v = a[q];
  return __shfl_sync(kFull, v, c & 31);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads) sweep_apply_kernel(
    float* __restrict__ w, const int* __restrict__ tids, const int* __restrict__ lids,
    const int* __restrict__ src, const int* __restrict__ runs,
    const float* __restrict__ payload, const float* __restrict__ wdu,
    const float* __restrict__ wdi, const float* __restrict__ scal,
    const int* __restrict__ stepi, int n_runs, int E, int n_pad, int W, int k, int tile,
    int e_cap, int reg_method, int user_nonneg, int item_nonneg, int with_user_bias) {
  const int lane = threadIdx.x & 31;
  const int run = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (run >= n_runs) return;
  const int p0 = runs[run];
  const int p1 = runs[run + 1];
  if (p0 >= p1) return;  // an empty run pads the batch's run list
  const int lid = lids[p0];
  const int64_t row = (int64_t)tids[p0 / e_cap] * tile + lid;
  if (lid < 0 || lid >= tile || row >= n_pad) __trap();

  // the run's payload sums, in plan order
  const int C = k + 3;
  float acc[kChunks];
#pragma unroll
  for (int q = 0; q < kChunks; ++q) acc[q] = 0.0f;
  for (int p = p0; p < p1; ++p) {
    const int s = src[p];
    if (s == E) continue;  // padding slot: a zero payload row
    if (s < 0 || s > E) __trap();
    const float* pr = payload + (int64_t)s * C;
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int c = 32 * q + lane;
      if (c < C) acc[q] += pr[c];
    }
  }
  const float db = column(acc, k);
  const float cu = column(acc, k + 1);
  const float ci = column(acc, k + 2);
  if (!((cu + ci) > 0.0f)) return;  // untouched: the row stays as it is

  const float lr = scal[0];
  const float wd_ub = scal[1];
  const float wd_ib = scal[2];
  const float wu = wdu[row];
  const float wi = wdi[row];
  float* x = w + row * W;
  int* xi = reinterpret_cast<int*>(x);
  const int step = stepi[0];

  float nw[kChunks] = {0.0f};
  if (reg_method >= 4) {
    const float el = (float)(step - xi[k + 1]);
    const float lam = lr * (cu > 0.0f ? wu : wi);
    const float fac = expf(el * log1m(lam));
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int c = 32 * q + lane;
      if (c < k) nw[q] = (reg_method == 4 ? x[c] * fac : soft(x[c], lam * el)) + acc[q];
    }
  } else {
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int c = 32 * q + lane;
      if (c < k) nw[q] = x[c] + acc[q];
    }
    if (reg_method == 2) {
      float sq = 0.0f;
#pragma unroll
      for (int q = 0; q < kChunks; ++q)
        if (32 * q + lane < k) sq += nw[q] * nw[q];
      sq = warp_sum(sq);
      const float wd_row = cu > 0.0f ? wu : wi;
      const float scale = sq > wd_row ? sqrtf(wd_row / fmaxf(sq, 1e-30f)) : 1.0f;
#pragma unroll
      for (int q = 0; q < kChunks; ++q) nw[q] *= scale;
    } else {
      const float fac0 = expf(cu * log1m(lr * wu) + ci * log1m(lr * wi));
      const float thr1 = lr * (wu * cu + wi * ci);
      const float thr3 = lr * wu * cu;
      const float fac3 = expf(ci * log1m(lr * wi));
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        if (reg_method == 0) nw[q] *= fac0;
        else if (reg_method == 1) nw[q] = soft(nw[q], thr1);
        else nw[q] = soft(nw[q], thr3) * fac3;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    if (user_nonneg && cu > 0.0f) nw[q] = fmaxf(nw[q], 0.0f);
    if (item_nonneg && ci > 0.0f) nw[q] = fmaxf(nw[q], 0.0f);
  }
  float logb = ci * log1m(lr * wd_ib);
  if (with_user_bias) logb += cu * log1m(lr * wd_ub);
  const float nb = (x[k] + db) * expf(logb);

  __syncwarp();  // every lane has read the row before any lane writes it
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const int c = 32 * q + lane;
    if (c < k) x[c] = nw[q];
  }
  if (lane == 0) {
    x[k] = nb;
    if (reg_method >= 4) xi[k + 1] = step;
  }
}

}  // namespace

extern "C" int sweep_apply(float* w, const int* tids, const int* lids, const int* src,
                           const int* runs, const float* payload, const float* wdu,
                           const float* wdi, const float* scal, const int* stepi, int n_runs,
                           int E, int n_pad, int W, int k, int tile, int e_cap, int reg_method,
                           int user_nonneg, int item_nonneg, int with_user_bias,
                           void* stream) {
  const int blocks = (n_runs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sweep_apply_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      w, tids, lids, src, runs, payload, wdu, wdi, scal, stepi, n_runs, E, n_pad, W, k, tile,
      e_cap, reg_method, user_nonneg, item_nonneg, with_user_bias);
  return (int)cudaGetLastError();
}
