// Stacked multi-IMFB training on Hopper: the per-step launches that differ
// from SVD++ (fused_svdpp.cu), whose pool flush, context gather and row
// apply the same host loop reuses.
//
// Replaces the TPU kernel svdfeature_tpu/ops/pallas_svdpp.py::_make_kernel
// with D>0 (launched by train_rounds_imfb_pallas), and computes what it
// computes, in f32 (the TPU kernel reads tables and payloads in bf16): the
// overlap-carried form of ops/imfb.train_epoch_imfb_carried.  Segments are
// a chunk's local feedback contexts, nseg of them with the pad context
// nseg-1 (always empty, always gated); step t holds up to RM rows of each
// of G units (slot s = g*RM + m), and each slot names its D active
// contexts in ctx[t, s, :].  Per step, on one stream:
//   * imfb_step (one block per unit, one warp per slot): p_u = u_val w[u] +
//     sum_d agg[ctx_d, :k], p_i = i_val w[i], the score with its biases
//     (the contexts' bias sums included), err; the u/i row updates go by
//     atomicAdd into acc[N, k+3] = [dw | db | cu | ci] (K1's layout); each
//     slot adds [err p_i | err | present | present/m_unit | |p_i|^2] into
//     cacc[ctx_d] of every non-pad context it names (m_unit: the present
//     rows of its unit, a reduction over the block's warps);
//   * imfb_delta (one block per context): from cacc and the carried
//     aggregates, the damped feedback step (only the within-unit excess
//     nrow - U is damped when RM > 1) times 1/norm times the chunk's gate,
//     delta[g]; dacc[g] += delta[g]; cacc[g] = 0 for the next step;
//   * svdpp_apply (fused_svdpp.cu) with G := nseg - 1: the row apply and
//     agg[:, :k+1] += O[c] @ delta over the non-pad contexts.
// At a chunk's first step svdpp_flush and svdpp_gather (fused_svdpp.cu)
// run with fb_ctx in place of fb_block and G := nseg - 1: the pad context
// is never gathered, so its agg row stays zero.  A call of R rounds x T
// steps with B chunk starts per round makes R * (3T + 2B) launches.
//
// Why the per-context sums go through atomics: a context is shared across
// units (a user's START half and its DEFAULT sub-block both read and
// update the user context, often within one step), so no block owns it.
// The sums therefore cross blocks, and the delta needs all of them: a
// separate launch reads them after every slot of the step has added.
//
// What bounds it on the card: arithmetic, not bytes, as for K2.  At the
// stacked implicitFeedback setting (G=128 units, RM=8, nseg=129, k=64,
// N=4308) tables, step planes, pools and overlaps sit in L2; O @ delta is
// 2 nseg^2 (k+1) = 2.2 MFLOP per step against a few tens of KFLOP for
// the slots, so the f32 rate sets the bound, a few microseconds per step.
// The design is the simple one: plain FMAs, host-issued launches.
//
// Plain C interface (ctypes, svdfeature_tpu_torch/ops/_build.py): each
// entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "sgd_common.cuh"

namespace {

constexpr int kMaxRowsPerUnit = 32;  // one warp per slot, at most 1024 threads
constexpr int kDeltaThreads = 128;

__global__ void __launch_bounds__(1024) imfb_step_kernel(
    const float* __restrict__ w, const float* __restrict__ b,
    const int* __restrict__ u_idx, const float* __restrict__ u_val,
    const int* __restrict__ i_idx, const float* __restrict__ i_val,
    const float* __restrict__ label, const float* __restrict__ weight,
    const int* __restrict__ ctx, const float* __restrict__ agg,
    const float* __restrict__ lrs, float* __restrict__ acc, float* __restrict__ cacc,
    int N, int k, int GS, int RM, int D, int nseg, int t, int r, int active_type,
    int with_user_bias, float base_score) {
  __shared__ float s_present[kMaxRowsPerUnit];
  const int g = blockIdx.x;
  const int m = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t x = (int64_t)t * GS + g * RM + m;
  const int u = u_idx[x];
  const float uv = u_val[x];
  const int it = i_idx[x];
  const float iv = i_val[x];
  const int* cs = ctx + x * D;
  const float* wu = w + (int64_t)u * k;
  const float* wi = w + (int64_t)it * k;
  const int ldg = k + 2;

  float dot = 0.0f;
  for (int c = lane; c < k; c += 32) {
    float fb = 0.0f;
    for (int d = 0; d < D; ++d) fb += agg[(int64_t)cs[d] * ldg + c];
    dot += (uv * wu[c] + fb) * (iv * wi[c]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);

  // every lane forms the same score, in the plain version's order
  float score = base_score + iv * b[it];
  if (with_user_bias) {
    float fbb = 0.0f;
    for (int d = 0; d < D; ++d) fbb += agg[(int64_t)cs[d] * ldg + k];
    score += uv * b[u];
    score += fbb;
  }
  score += dot;
  const float present = weight[x];
  const float err = sgd::active_grad(score, label[x], active_type) * present;
  const float lr_err = lrs[r] * err;
  const float coef_u = lr_err * uv;
  const float coef_i = lr_err * iv;

  const int lda = k + 3;
  const int ldc = k + 4;
  float* au = acc + (int64_t)u * lda;
  float* ai = acc + (int64_t)it * lda;
  float pip2 = 0.0f;
  for (int c = lane; c < k; c += 32) {
    float fb = 0.0f;
    for (int d = 0; d < D; ++d) fb += agg[(int64_t)cs[d] * ldg + c];
    const float pu = uv * wu[c] + fb;
    const float pi = iv * wi[c];
    if (u != N - 1) atomicAdd(au + c, coef_u * pi);
    if (it != N - 1) atomicAdd(ai + c, coef_i * pu);
    // the pad context is always empty: its delta is 0 whatever it sums
    for (int d = 0; d < D; ++d) {
      if (cs[d] != nseg - 1) atomicAdd(cacc + (int64_t)cs[d] * ldc + c, err * pi);
    }
    pip2 += pi * pi;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) pip2 += __shfl_xor_sync(0xffffffffu, pip2, o);
  if (lane == 0) {
    if (u != N - 1) {
      if (with_user_bias) atomicAdd(au + k, coef_u);
      atomicAdd(au + k + 1, 1.0f);
    }
    if (it != N - 1) {
      atomicAdd(ai + k, coef_i);
      atomicAdd(ai + k + 2, 1.0f);
    }
    s_present[m] = present;
  }
  __syncthreads();
  if (lane == 0) {
    float m_unit = 0.0f;
    for (int j = 0; j < RM; ++j) m_unit += s_present[j];
    const float ind = m_unit > 0.0f ? present * (1.0f / fmaxf(m_unit, 1.0f)) : 0.0f;
    for (int d = 0; d < D; ++d) {
      if (cs[d] == nseg - 1) continue;
      float* cc = cacc + (int64_t)cs[d] * ldc;
      atomicAdd(cc + k, err);
      atomicAdd(cc + k + 1, present);
      atomicAdd(cc + k + 2, ind);
      atomicAdd(cc + k + 3, pip2);
    }
  }
}

// One block per non-pad context g of chunk c: the feedback step from the
// step's sums cacc[g] = [sum err p_i | sum err | nrow | U | sum |p_i|^2]
// (ops/imfb.train_epoch_imfb_carried body, same formulas), then cacc[g] = 0.
__global__ void __launch_bounds__(kDeltaThreads) imfb_delta_kernel(
    const float* __restrict__ agg, const float* __restrict__ inv,
    const float* __restrict__ enabled, const float* __restrict__ lr_fbs,
    const float* __restrict__ log_d, const float* __restrict__ log_db,
    float* __restrict__ cacc, float* __restrict__ dacc, float* __restrict__ delta, int k,
    int nseg, int RM, int c, int r, int with_user_bias) {
  const int g = blockIdx.x;
  float* cc = cacc + (int64_t)g * (k + 4);
  const float* ag = agg + (int64_t)g * (k + 2);
  const float err_g = cc[k];
  const float nrow = cc[k + 1];
  const float lr_fb = lr_fbs[r];
  const float norm = ag[k + 1];
  float damp_pi = 1.0f, damp_b = 1.0f;
  if (RM > 1) {
    // implicit damping of the within-unit excess of the widened step
    const float excess = fmaxf(nrow - cc[k + 2], 0.0f);
    const float frac = nrow > 0.0f ? excess / fmaxf(nrow, 1.0f) : 0.0f;
    damp_pi = 1.0f + lr_fb * norm * cc[k + 3] * frac;
    damp_b = 1.0f + lr_fb * norm * excess;
  }
  const float powd = expf(nrow * log_d[r]) - 1.0f;  // d^nrow - 1
  const float powdb = expf(nrow * log_db[r]) - 1.0f;
  // disabled depths neither accumulate nor decay (apex_multi_imfb.h:85-87)
  const float scale = inv[g] * enabled[(int64_t)c * nseg + g];
  float* dl = delta + (int64_t)g * (k + 1);
  float* da = dacc + (int64_t)g * (k + 1);
  for (int j = threadIdx.x; j < k + 1; j += blockDim.x) {
    float dv;
    if (j < k) {
      dv = (ag[j] * powd + lr_fb * norm * (cc[j] / damp_pi)) * scale;
    } else {
      dv = with_user_bias ? (ag[k] * powdb + lr_fb * norm * (err_g / damp_b)) * scale : 0.0f;
    }
    dl[j] = dv;
    da[j] += dv;
  }
  __syncthreads();  // every thread has read the sums before they are cleared
  for (int j = threadIdx.x; j < k + 4; j += blockDim.x) cc[j] = 0.0f;
}

}  // namespace

extern "C" int imfb_step(const float* w, const float* b, const int* u_idx, const float* u_val,
                         const int* i_idx, const float* i_val, const float* label,
                         const float* weight, const int* ctx, const float* agg,
                         const float* lrs, float* acc, float* cacc, int N, int k, int GS, int RM,
                         int D, int nseg, int t, int r, int active_type, int with_user_bias,
                         float base_score, void* stream) {
  if (RM < 1 || RM > kMaxRowsPerUnit || GS % RM) return (int)cudaErrorInvalidValue;
  imfb_step_kernel<<<GS / RM, RM * 32, 0, (cudaStream_t)stream>>>(
      w, b, u_idx, u_val, i_idx, i_val, label, weight, ctx, agg, lrs, acc, cacc, N, k, GS, RM,
      D, nseg, t, r, active_type, with_user_bias, base_score);
  return (int)cudaGetLastError();
}

extern "C" int imfb_delta(const float* agg, const float* inv, const float* enabled,
                          const float* lr_fbs, const float* log_d, const float* log_db,
                          float* cacc, float* dacc, float* delta, int k, int nseg, int RM, int c,
                          int r, int with_user_bias, void* stream) {
  imfb_delta_kernel<<<nseg - 1, kDeltaThreads, 0, (cudaStream_t)stream>>>(
      agg, inv, enabled, lr_fbs, log_d, log_db, cacc, dacc, delta, k, nseg, RM, c, r,
      with_user_bias);
  return (int)cudaGetLastError();
}
