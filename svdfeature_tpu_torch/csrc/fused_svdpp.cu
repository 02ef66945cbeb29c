// SVD++ (user-group) training on Hopper: per chunk a pool flush and an
// aggregate gather, per step a per-user forward/scatter/feedback launch and
// an apply launch.
//
// Replaces the TPU kernel svdfeature_tpu/ops/pallas_svdpp.py::_make_kernel
// with D=0 (launched by train_rounds_svdpp_pallas), and computes what it
// computes, in f32 (the TPU kernel reads tables and payloads in bf16):
// the overlap-carried form of ops/svdpp.train_epoch_plus.  Chunk c holds G
// users; step t of it holds up to M rows of each (slot s = g*M + m).
//   * boundary (first step of a chunk): svdpp_flush adds the previous
//     chunk's accumulated per-user deltas to its pool rows,
//     w[fb_idx] += dacc[fb_block] * fval (and b with user bias); then
//     svdpp_gather forms the new chunk's agg[g] = [sum fval w[fb_idx] |
//     sum fval b[fb_idx] | sum fval^2], inv[g] = 1/norm, dacc[g] = 0;
//   * svdpp_step: p_u = u_val w[u] + agg[g, :k], p_i = sum_SI i_val w[i],
//     the score with its biases, err; the u/i row updates go by atomicAdd
//     into acc[N, k+3] = [dw | db | cu | ci] (K1's layout); the per-user
//     sums of err p_i, err, present rows and |p_i|^2 give the damped
//     feedback step delta[g] (rows_per_user > 1), dacc[g] += delta[g];
//   * svdpp_apply: every touched row w = (w + dw) * exp(touch decay), as
//     K1's sgd_apply (sgd_common.cuh), and in the same launch
//     agg[v, :k+1] += sum_u O[c, v, u] delta[u] (the TPU kernel's in-body
//     O @ delta).
// Split launches on one stream put every read of a step (w rows, agg)
// before any write of it; a call of R rounds x T steps with B chunk starts
// per round makes R * (2T + 2B) launches (the first flush of a call is
// skipped, one final flush is added).
//
// What bounds it on the card: arithmetic, not bytes.  At the
// implicitFeedback band setting (G=128, M=8, k=64, N=4308) the tables
// (1.1 MB), a round's step planes (3.9 MB), the pools and the overlap
// matrices sit in L2; the O @ delta product is 2 G (G+1) (k+1) = 2.1 MFLOP
// per step against a few tens of KFLOP for the slots, so the f32 rate
// (67 TFLOP/s) sets the bound, a few microseconds per step.  This first
// design does that product with plain FMAs, one block per output row and
// one thread per column (L2-resident operands, O read as a warp
// broadcast); tensor cores, a CUDA graph over the launches or a persistent
// kernel are later work.  Per-user reductions need no atomics: a block per
// user reduces its M warps in shared memory, and a user's pool entries
// are contiguous (data/batching_plus.py), so a block per user sums its
// own segment [seg[g], seg[g+1]).  Pool rows are shared by users, so the
// flush uses atomics.  Slots whose index is the dummy row N-1 (padding)
// scatter nothing: the apply writes that row as zeros either way.
//
// Plain C interface (ctypes, svdfeature_tpu_torch/ops/_build.py): each
// entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "sgd_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kGatherWarps = 4;

// w[fb_idx[f]] += dacc[fb_block[f]] * fval[f] over the live entries of
// chunk c (one warp per entry; atomics: pool rows repeat across users)
__global__ void __launch_bounds__(kThreads) svdpp_flush_kernel(
    float* __restrict__ w, float* __restrict__ b, const int* __restrict__ fb_idx,
    const float* __restrict__ fb_val, const int* __restrict__ fb_block,
    const float* __restrict__ dacc, int F, int k, int c, int live, int with_user_bias) {
  const int f = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (f >= live) return;
  const int lane = threadIdx.x & 31;
  const int64_t e = (int64_t)c * F + f;
  const int row = fb_idx[e];
  const float v = fb_val[e];
  const float* d = dacc + (int64_t)fb_block[e] * (k + 1);
  float* wr = w + (int64_t)row * k;
  for (int col = lane; col < k; col += 32) atomicAdd(wr + col, d[col] * v);
  if (lane == 0 && with_user_bias) atomicAdd(b + row, d[k] * v);
}

// agg[g] = [sum fval w[fb_idx] | sum fval b[fb_idx] | sum fval^2] over
// user g's segment of chunk c; inv[g] = 1/norm (0 for an empty pool);
// dacc[g] = 0.  One block per user, columns in tiles of 32 lanes, pool
// entries strided over the block's warps, reduced in shared memory.
__global__ void __launch_bounds__(kGatherWarps * 32) svdpp_gather_kernel(
    const float* __restrict__ w, const float* __restrict__ b,
    const int* __restrict__ fb_idx, const float* __restrict__ fb_val,
    const int* __restrict__ seg, float* __restrict__ agg, float* __restrict__ inv,
    float* __restrict__ dacc, int F, int k, int G, int c, int with_user_bias) {
  __shared__ float part[kGatherWarps][32];
  const int g = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int start = seg[(int64_t)c * (G + 1) + g];
  const int end = seg[(int64_t)c * (G + 1) + g + 1];
  const int64_t base = (int64_t)c * F;
  for (int c0 = 0; c0 < k + 2; c0 += 32) {
    const int col = c0 + lane;
    float s = 0.0f;
    for (int f = start + warp; f < end; f += kGatherWarps) {
      const float v = fb_val[base + f];
      const int row = fb_idx[base + f];
      if (col < k) {
        s += v * w[(int64_t)row * k + col];
      } else if (col == k) {
        if (with_user_bias) s += v * b[row];
      } else if (col == k + 1) {
        s += v * v;
      }
    }
    part[warp][lane] = s;
    __syncthreads();
    if (warp == 0 && col < k + 2) {
      float t = 0.0f;
      for (int j = 0; j < kGatherWarps; ++j) t += part[j][lane];
      agg[(int64_t)g * (k + 2) + col] = t;
      if (col == k + 1) inv[g] = t > 0.0f ? 1.0f / fmaxf(t, 1e-30f) : 0.0f;
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < k + 1; j += blockDim.x) dacc[(int64_t)g * (k + 1) + j] = 0.0f;
}

// One block per user g, one warp per slot s = g*M + m of step t.
// Dynamic shared memory: red[M][k] (err * p_i), then err, present and
// |p_i|^2 per slot.
__global__ void __launch_bounds__(1024) svdpp_step_kernel(
    const float* __restrict__ w, const float* __restrict__ b,
    const int* __restrict__ u_idx, const float* __restrict__ u_val,
    const int* __restrict__ i_idx, const float* __restrict__ i_val,
    const float* __restrict__ label, const float* __restrict__ weight,
    const float* __restrict__ agg, const float* __restrict__ inv,
    const float* __restrict__ lrs, const float* __restrict__ lr_fbs,
    const float* __restrict__ log_d, const float* __restrict__ log_db,
    float* __restrict__ acc, float* __restrict__ dacc, float* __restrict__ delta,
    int N, int k, int G, int M, int SI, int t, int r, int active_type,
    int with_user_bias, float base_score) {
  extern __shared__ float smem[];
  float* red = smem;              // [M][k]
  float* s_err = red + M * k;     // [M]
  float* s_present = s_err + M;   // [M]
  float* s_pip2 = s_present + M;  // [M]
  const int g = blockIdx.x;
  const int m = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int GS = G * M;
  const int64_t x = (int64_t)t * GS + g * M + m;
  const int u = u_idx[x];
  const float uv = u_val[x];
  const int* it = i_idx + x * SI;
  const float* iv = i_val + x * SI;
  const float* wu = w + (int64_t)u * k;
  const float* ag = agg + (int64_t)g * (k + 2);

  float dot = 0.0f;
  for (int c = lane; c < k; c += 32) {
    const float pu = uv * wu[c] + ag[c];
    float pi = 0.0f;
    for (int s = 0; s < SI; ++s) pi += iv[s] * w[(int64_t)it[s] * k + c];
    dot += pu * pi;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);

  // every lane forms the same score, in the plain version's order
  float score = base_score;
  for (int s = 0; s < SI; ++s) score += iv[s] * b[it[s]];
  if (with_user_bias) score += uv * b[u] + ag[k];
  score += dot;
  const float present = weight[x];
  const float err = sgd::active_grad(score, label[x], active_type) * present;
  const float lr_err = lrs[r] * err;
  const float coef_u = lr_err * uv;

  const int ld = k + 3;
  float* au = acc + (int64_t)u * ld;
  float pip2 = 0.0f;
  for (int c = lane; c < k; c += 32) {
    const float pu = uv * wu[c] + ag[c];
    float pi = 0.0f;
    for (int s = 0; s < SI; ++s) pi += iv[s] * w[(int64_t)it[s] * k + c];
    if (u != N - 1) atomicAdd(au + c, coef_u * pi);
    for (int s = 0; s < SI; ++s) {
      if (it[s] != N - 1) atomicAdd(acc + (int64_t)it[s] * ld + c, lr_err * iv[s] * pu);
    }
    red[m * k + c] = err * pi;
    pip2 += pi * pi;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) pip2 += __shfl_xor_sync(0xffffffffu, pip2, o);
  if (lane == 0) {
    if (u != N - 1) {
      if (with_user_bias) atomicAdd(au + k, coef_u);
      atomicAdd(au + k + 1, 1.0f);
    }
    for (int s = 0; s < SI; ++s) {
      if (it[s] == N - 1) continue;
      float* ai = acc + (int64_t)it[s] * ld;
      atomicAdd(ai + k, lr_err * iv[s]);
      atomicAdd(ai + k + 2, 1.0f);
    }
    s_err[m] = err;
    s_present[m] = present;
    s_pip2[m] = pip2;
  }
  __syncthreads();

  // the user's feedback step (train_epoch_plus body, same formulas)
  float m_g = 0.0f, err_g = 0.0f, pip2_g = 0.0f;
  for (int j = 0; j < M; ++j) {
    m_g += s_present[j];
    err_g += s_err[j];
    pip2_g += s_pip2[j];
  }
  const float lr_fb = lr_fbs[r];
  const float norm = ag[k + 1];
  const float invg = inv[g];
  float damp_pi = 1.0f, damp_b = 1.0f;
  if (M > 1) {
    // implicit damping of the M-wide within-user Jacobi step
    const float frac = m_g > 0.0f ? (m_g - 1.0f) / fmaxf(m_g, 1.0f) : 0.0f;
    damp_pi = 1.0f + lr_fb * norm * pip2_g * frac;
    damp_b = 1.0f + lr_fb * norm * (m_g > 0.0f ? m_g - 1.0f : 0.0f);
  }
  const float powd = expf(m_g * log_d[r]) - 1.0f;  // d^m_g - 1
  const float powdb = expf(m_g * log_db[r]) - 1.0f;
  float* dl = delta + (int64_t)g * (k + 1);
  float* da = dacc + (int64_t)g * (k + 1);
  for (int j = threadIdx.x; j < k + 1; j += blockDim.x) {
    float dv;
    if (j < k) {
      float errpi = 0.0f;
      for (int mm = 0; mm < M; ++mm) errpi += red[mm * k + j];
      errpi = errpi / damp_pi;
      dv = (ag[j] * powd + lr_fb * norm * errpi) * invg;
    } else {
      dv = with_user_bias ? (ag[k] * powdb + lr_fb * norm * (err_g / damp_b)) * invg : 0.0f;
    }
    dl[j] = dv;
    da[j] += dv;
  }
}

// Blocks [0, row_blocks): one warp per table row, the step's row apply.
// Blocks [row_blocks, row_blocks + G): output row v of agg[:, :k+1] +=
// O[c] @ delta, one thread per column.
__global__ void __launch_bounds__(kThreads) svdpp_apply_kernel(
    float* __restrict__ w, float* __restrict__ b, float* __restrict__ acc,
    float* __restrict__ agg, const float* __restrict__ delta,
    const float* __restrict__ O, const float* __restrict__ log_u,
    const float* __restrict__ log_i, const float* __restrict__ log_bu,
    const float* __restrict__ log_bi, int N, int k, int G, int c, int r,
    int with_user_bias, int row_blocks) {
  if ((int)blockIdx.x < row_blocks) {
    const int n = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (n >= N) return;
    sgd::apply_row(w, b, acc, log_u, log_i, log_bu, log_bi, N, k, r, with_user_bias, n,
                   threadIdx.x & 31);
    return;
  }
  const int v = blockIdx.x - row_blocks;
  const float* Ov = O + ((int64_t)c * (G + 1) + v) * (G + 1);
  for (int j = threadIdx.x; j < k + 1; j += blockDim.x) {
    float s = 0.0f;
    for (int u = 0; u < G; ++u) s += Ov[u] * delta[(int64_t)u * (k + 1) + j];
    agg[(int64_t)v * (k + 2) + j] += s;
  }
}

}  // namespace

extern "C" int svdpp_flush(float* w, float* b, const int* fb_idx, const float* fb_val,
                           const int* fb_block, const float* dacc, int F, int k, int c,
                           int live, int with_user_bias, void* stream) {
  const int blocks = live > 0 ? (live + kWarpsPerBlock - 1) / kWarpsPerBlock : 1;
  svdpp_flush_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      w, b, fb_idx, fb_val, fb_block, dacc, F, k, c, live, with_user_bias);
  return (int)cudaGetLastError();
}

extern "C" int svdpp_gather(const float* w, const float* b, const int* fb_idx,
                            const float* fb_val, const int* seg, float* agg, float* inv,
                            float* dacc, int F, int k, int G, int c, int with_user_bias,
                            void* stream) {
  svdpp_gather_kernel<<<G, kGatherWarps * 32, 0, (cudaStream_t)stream>>>(
      w, b, fb_idx, fb_val, seg, agg, inv, dacc, F, k, G, c, with_user_bias);
  return (int)cudaGetLastError();
}

extern "C" int svdpp_step(const float* w, const float* b, const int* u_idx,
                          const float* u_val, const int* i_idx, const float* i_val,
                          const float* label, const float* weight, const float* agg,
                          const float* inv, const float* lrs, const float* lr_fbs,
                          const float* log_d, const float* log_db, float* acc, float* dacc,
                          float* delta, int N, int k, int G, int M, int SI, int t, int r,
                          int active_type, int with_user_bias, float base_score,
                          void* stream) {
  const size_t smem = sizeof(float) * (size_t)M * (k + 3);
  svdpp_step_kernel<<<G, M * 32, smem, (cudaStream_t)stream>>>(
      w, b, u_idx, u_val, i_idx, i_val, label, weight, agg, inv, lrs, lr_fbs, log_d,
      log_db, acc, dacc, delta, N, k, G, M, SI, t, r, active_type, with_user_bias,
      base_score);
  return (int)cudaGetLastError();
}

extern "C" int svdpp_apply(float* w, float* b, float* acc, float* agg, const float* delta,
                           const float* O, const float* log_u, const float* log_i,
                           const float* log_bu, const float* log_bi, int N, int k, int G,
                           int c, int r, int with_user_bias, void* stream) {
  const int row_blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  svdpp_apply_kernel<<<row_blocks + G, kThreads, 0, (cudaStream_t)stream>>>(
      w, b, acc, agg, delta, O, log_u, log_i, log_bu, log_bi, N, k, G, c, r,
      with_user_bias, row_blocks);
  return (int)cudaGetLastError();
}
