// Stacked multi-IMFB training on Hopper: a call of R rounds x T steps as
// one persistent cooperative launch, imfb_rounds, whose phases (pool
// flush, context gather, per-unit step, per-context delta, apply) are
// separated by grid-wide barriers.  The flush, gather and apply are K2's
// bodies (feedback_common.cuh, sgd_common.cuh) with G := nseg - 1.
//
// Replaces the TPU kernel svdfeature_tpu/ops/pallas_svdpp.py::_make_kernel
// with D>0 (launched by train_rounds_imfb_pallas), and computes what it
// computes, in f32 (the TPU kernel reads tables and payloads in bf16): the
// overlap-carried form of ops/imfb.train_epoch_imfb_carried.  Segments are
// a chunk's local feedback contexts, nseg of them with the pad context
// nseg-1 (always empty, always gated); step t holds up to RM rows of each
// of G units (slot s = g*RM + m), and each slot names its D active
// contexts in ctx[t, s, :].
//   * chunk start (first step of a chunk): the flush adds the previous
//     chunk's accumulated per-context deltas to its pool rows (fb_ctx in
//     K2's fb_block); then the gather forms each non-pad context's agg, inv
//     and clears its dacc.  The pad context is never gathered: its agg row
//     stays 0;
//   * step (a block per unit, a warp per slot): p_u = u_val w[u] +
//     sum_d agg[ctx_d, :k], p_i = i_val w[i], the score with its biases
//     (the contexts' bias sums included), err; the u/i row updates go by
//     atomicAdd into acc[N, k+3] = [dw | db | cu | ci] (K1's layout); each
//     slot adds [err p_i | err | present | present/m_unit | |p_i|^2] into
//     cacc[ctx_d] of every non-pad context it names (m_unit: the present
//     rows of its unit, a reduction over the block's warps);
//   * delta (a warp per non-pad context): from cacc and the carried
//     aggregates, the damped feedback step (only the within-unit excess
//     nrow - U is damped when RM > 1) times 1/norm times the chunk's gate,
//     delta[g]; dacc[g] += delta[g]; cacc[g] = 0 for the next step;
//   * apply: every touched row w = (w + dw) * exp(touch decay)
//     (sgd::apply_touched_rows) while product groups add
//     agg[:, :k+1] += O[c] @ delta over the non-pad contexts on the tensor
//     cores (overlap_mma).
// The per-context sums go through atomics because a context is shared
// across units (a user's START half and its DEFAULT sub-block both read
// and update the user context, often within one step), so no block owns
// it; the delta needs all of them, hence a barrier between step and delta,
// and the product needs every delta, hence one between delta and apply:
// three barriers a step against K2's two.  Every read of a step precedes
// any write of it, as the reference trajectory needs.  A block strides
// over units when G exceeds the grid.  The first flush of a call is
// skipped and one final flush is added.
//
// What bounds it on the card: latency, as for K2.  At the stacked
// implicitFeedback setting (G=128 units, RM=8, nseg=129, k=64, N=4308)
// tables, step planes, pools and overlaps sit in L2; O @ delta is
// 2 (nseg-1)^2 (k+1) = 2.1 MFLOP a step, a fraction of a microsecond at the
// f32 rate, and a step's chain is a handful of L2 round trips and three
// grid barriers.  What the design does about it: one launch per call (a
// step's card time, ~11 us, is less than the host cost of its launches),
// the decay logs formed in the kernel, a warp's next slot read ahead of
// the step's barriers, p_u / p_i kept in registers between the dot and
// the scatter, and the delta a warp per context (no block barrier inside
// it) with all of a lane's columns read before any store.
//
// Plain C interface (ctypes, svdfeature_tpu_torch/ops/_build.py): the
// entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() or the error of the
// call that failed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "feedback_common.cuh"
#include "sgd_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRowsPerUnit = 32;  // one warp per slot, at most 1024 threads
constexpr int kSlotCtx = 2;          // contexts a slot carries in registers; more are read in the step

struct ImfbRounds {
  // the tables (updated in place) and the call's scratch, all written
  // during the launch: never read through the read-only path
  float *w, *b, *acc, *agg, *inv, *dacc, *delta, *cacc;
  // inputs, read only
  const int *u_idx, *i_idx, *ctx, *fb_idx, *fb_ctx, *seg, *cid, *first, *live;
  const float *u_val, *i_val, *label, *weight, *fb_val, *O, *enabled;
  const float *lrs, *wd_u, *wd_i, *wd_ub, *wd_ib;
  // null, or 11 sums of nanoseconds: as block 0's first thread sees them, its
  // own work in the flush, gather, step, delta and apply phases [0..4], then
  // the barrier after each [5..9] (which waits for the slowest block); and
  // the apply phase's product as block 0's product group sees it [10]
  long long* trace;
  int N, k, G, RM, D, nseg, T, R, F, active_type, with_user_bias;
  float base_score, scale_lr_fb, wd_fb, wd_fbb;
};

// One slot's planes and its first contexts.  They are inputs, never
// written, so a warp may read its next slot before the barriers that end
// this step.
struct Slot {
  int u, it, ctx[kSlotCtx];
  float uv, iv, label, weight;
};

__device__ __forceinline__ Slot load_slot(const ImfbRounds& a, int64_t x) {
  Slot s;
  s.u = __ldg(a.u_idx + x);
  s.it = __ldg(a.i_idx + x);
  s.uv = __ldg(a.u_val + x);
  s.iv = __ldg(a.i_val + x);
  s.label = __ldg(a.label + x);
  s.weight = __ldg(a.weight + x);
#pragma unroll
  for (int d = 0; d < kSlotCtx; ++d) s.ctx[d] = d < a.D ? __ldg(a.ctx + x * a.D + d) : a.nseg - 1;
  return s;
}

// fn(cx) for each context cx of slot x in order: the first kSlotCtx from
// the slot's registers (indices known at compile time, so the array stays
// in registers), the rest read here
template <class Fn>
__device__ __forceinline__ void for_each_ctx(const ImfbRounds& a, const Slot& s, int64_t x,
                                             Fn fn) {
#pragma unroll
  for (int d = 0; d < kSlotCtx; ++d) {
    if (d < a.D) fn(s.ctx[d]);
  }
  for (int d = kSlotCtx; d < a.D; ++d) fn(__ldg(a.ctx + x * a.D + d));
}

// sum_d agg[ctx_d, col] in context order
__device__ __forceinline__ float ctx_sum(const ImfbRounds& a, const Slot& s, int64_t x, int col) {
  const int ld = a.k + 2;
  float fb = 0.0f;
  for_each_ctx(a, s, x, [&](int cx) { fb += a.agg[(int64_t)cx * ld + col]; });
  return fb;
}

// Unit g's step: warp m < RM takes slot x = (t G + g) RM + m (its planes in
// ``s``).  Shared memory: the present flag of each slot, [RM].
__device__ __forceinline__ void step_unit(const ImfbRounds& a, const Slot& s, int64_t x, float lr,
                                          float* s_present) {
  const int N = a.N, k = a.k, RM = a.RM, pad = a.nseg - 1;
  const int m = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float err = 0.0f, present = 0.0f, pip2 = 0.0f;
  if (m < RM) {
    const float* wu = a.w + (int64_t)s.u * k;
    const float* wi = a.w + (int64_t)s.it * k;
    float pu_r[kRegCols], pi_r[kRegCols];
    float dot = 0.0f;
#pragma unroll
    for (int q = 0; q < kRegCols; ++q) {
      const int c = lane + 32 * q;
      pu_r[q] = 0.0f;
      pi_r[q] = 0.0f;
      if (c < k) {
        pu_r[q] = s.uv * wu[c] + ctx_sum(a, s, x, c);
        pi_r[q] = s.iv * wi[c];
        dot += pu_r[q] * pi_r[q];
      }
    }
    for (int c = lane + 32 * kRegCols; c < k; c += 32)
      dot += (s.uv * wu[c] + ctx_sum(a, s, x, c)) * (s.iv * wi[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);

    // every lane forms the same score, in the plain version's order
    float score = a.base_score + s.iv * a.b[s.it];
    if (a.with_user_bias) {
      const float fbb = ctx_sum(a, s, x, k);
      score += s.uv * a.b[s.u];
      score += fbb;
    }
    score += dot;
    present = s.weight;
    err = sgd::active_grad(score, s.label, a.active_type) * present;
    const float lr_err = lr * err;
    const float coef_u = lr_err * s.uv;
    const float coef_i = lr_err * s.iv;

    const int lda = k + 3, ldc = k + 4;
    float* au = a.acc + (int64_t)s.u * lda;
    float* ai = a.acc + (int64_t)s.it * lda;
    const bool real_u = s.u != N - 1, real_i = s.it != N - 1;
    auto scatter = [&](int c, float pu, float pi) {
      if (real_u) atomicAdd(au + c, coef_u * pi);
      if (real_i) atomicAdd(ai + c, coef_i * pu);
      // the pad context is always empty: its delta is 0 whatever it sums
      for_each_ctx(a, s, x, [&](int cx) {
        if (cx != pad) atomicAdd(a.cacc + (int64_t)cx * ldc + c, err * pi);
      });
      pip2 += pi * pi;
    };
#pragma unroll
    for (int q = 0; q < kRegCols; ++q) {
      const int c = lane + 32 * q;
      if (c < k) scatter(c, pu_r[q], pi_r[q]);
    }
    for (int c = lane + 32 * kRegCols; c < k; c += 32)
      scatter(c, s.uv * wu[c] + ctx_sum(a, s, x, c), s.iv * wi[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) pip2 += __shfl_xor_sync(kFull, pip2, o);
    if (lane == 0) {
      if (real_u) {
        if (a.with_user_bias) atomicAdd(au + k, coef_u);
        atomicAdd(au + k + 1, 1.0f);
      }
      if (real_i) {
        atomicAdd(ai + k, coef_i);
        atomicAdd(ai + k + 2, 1.0f);
      }
      s_present[m] = present;
    }
  }
  __syncthreads();
  if (m < RM && lane == 0) {
    float m_unit = 0.0f;
    for (int j = 0; j < RM; ++j) m_unit += s_present[j];
    const float ind = m_unit > 0.0f ? present * (1.0f / fmaxf(m_unit, 1.0f)) : 0.0f;
    for_each_ctx(a, s, x, [&](int cx) {
      if (cx == pad) return;
      float* cc = a.cacc + (int64_t)cx * (k + 4);
      atomicAdd(cc + k, err);
      atomicAdd(cc + k + 1, present);
      atomicAdd(cc + k + 2, ind);
      atomicAdd(cc + k + 3, pip2);
    });
  }
}

// Non-pad context g of chunk c, one warp: the feedback step from the
// step's sums cacc[g] = [sum err p_i | sum err | nrow | U | sum |p_i|^2]
// (ops/imfb.train_epoch_imfb_carried body, same formulas), then cacc[g] = 0.
// A lane's columns (kDeltaCols of them for k < 128) are all read before
// the first store, with the sums and the gate: one L2 round trip for the
// loads, not one per column pass.
constexpr int kDeltaCols = 4;
__device__ __forceinline__ void delta_context(const ImfbRounds& a, int g, int c, float lr_fb,
                                              float log_d, float log_db, int lane) {
  const int k = a.k;
  float* cc = a.cacc + (int64_t)g * (k + 4);
  const float* ag = a.agg + (int64_t)g * (k + 2);
  float* dl = a.delta + (int64_t)g * (k + 1);
  float* da = a.dacc + (int64_t)g * (k + 1);
  // columns j < k: [agg | err p_i sums]; column k: [bias agg | err sum]
  float agv[kDeltaCols], ccv[kDeltaCols], dav[kDeltaCols];
#pragma unroll
  for (int q = 0; q < kDeltaCols; ++q) {
    const int j = lane + 32 * q;
    if (j < k + 1) {
      agv[q] = ag[j];
      ccv[q] = cc[j];
      dav[q] = da[j];
    }
  }
  const float nrow = cc[k + 1];
  const float units = cc[k + 2];
  const float pip2 = cc[k + 3];
  const float norm = ag[k + 1];
  // disabled depths neither accumulate nor decay (apex_multi_imfb.h:85-87)
  const float scale = a.inv[g] * __ldg(a.enabled + (int64_t)c * a.nseg + g);
  float damp_pi = 1.0f, damp_b = 1.0f;
  if (a.RM > 1) {
    // implicit damping of the within-unit excess of the widened step
    const float excess = fmaxf(nrow - units, 0.0f);
    const float frac = nrow > 0.0f ? excess / fmaxf(nrow, 1.0f) : 0.0f;
    damp_pi = 1.0f + lr_fb * norm * pip2 * frac;
    damp_b = 1.0f + lr_fb * norm * excess;
  }
  const float powd = expf(nrow * log_d) - 1.0f;  // d^nrow - 1
  const float powdb = expf(nrow * log_db) - 1.0f;
  auto step = [&](int j, float agj, float ccj) {
    if (j < k) return (agj * powd + lr_fb * norm * (ccj / damp_pi)) * scale;
    return a.with_user_bias ? (agj * powdb + lr_fb * norm * (ccj / damp_b)) * scale : 0.0f;
  };
#pragma unroll
  for (int q = 0; q < kDeltaCols; ++q) {
    const int j = lane + 32 * q;
    if (j < k + 1) {
      const float dv = step(j, agv[q], ccv[q]);
      dl[j] = dv;
      da[j] = dav[q] + dv;
    }
  }
  for (int j = lane + 32 * kDeltaCols; j < k + 1; j += 32) {
    const float dv = step(j, ag[j], cc[j]);
    dl[j] = dv;
    da[j] += dv;
  }
  __syncwarp();  // every lane has read the sums before they are cleared
  for (int j = lane; j < k + 4; j += 32) cc[j] = 0.0f;
}

template <int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) imfb_rounds_kernel(const ImfbRounds a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int bid = blockIdx.x, nblocks = gridDim.x;
  const int gwarp = bid * nw + warp, nwarps = nblocks * nw;
  const int N = a.N, k = a.k, G = a.G, RM = a.RM, T = a.T;
  const int NC = a.nseg - 1;  // non-pad contexts: K2's segments

  // the dummy row stays exactly 0 (padding slots scatter nothing into it);
  // only padding slots, of weight 0, read it
  if (bid == 0) {
    for (int j = threadIdx.x; j < k; j += blockDim.x) a.w[(int64_t)(N - 1) * k + j] = 0.0f;
    if (threadIdx.x == 0) a.b[N - 1] = 0.0f;
  }
  sgd::PhaseClock clock{bid == 0 && threadIdx.x == 0 ? a.trace : nullptr, 0};
  if (clock.trace != nullptr) clock.last = sgd::now_ns();
  // the apply phase: product groups and row warps
  const ApplyRoles role(k, NC, bid, nblocks, warp, nw);

  // with a block per unit (G within the grid) a warp reads its next slot
  // before the step's barriers, so the planes are there when the step starts
  const bool pipelined = G <= nblocks;
  const bool has_slot = pipelined && bid < G && warp < RM;
  Slot next;
  if (has_slot) next = load_slot(a, (int64_t)bid * RM + warp);

  bool started = false;  // the first flush of a call is skipped
  for (int r = 0; r < a.R; ++r) {
    const float lr = __ldg(a.lrs + r);
    const float lr_fb = lr * a.scale_lr_fb;
    const float log_d = sgd::log1m_rate(lr_fb, a.wd_fb);
    const float log_db = sgd::log1m_rate(lr_fb, a.wd_fbb);
    const sgd::RateDecay decay{a.wd_u, a.wd_i, lr, sgd::log1m_rate(lr, __ldg(a.wd_ub)),
                               sgd::log1m_rate(lr, __ldg(a.wd_ib)), a.with_user_bias};
    for (int t = 0; t < T; ++t) {
      const int c = __ldg(a.cid + t);
      if (__ldg(a.first + t)) {
        if (started) {  // t = 0: the previous round's last chunk
          const int pc = __ldg(a.cid + (t ? t - 1 : T - 1));
          flush_pool(a.w, a.b, a.fb_idx, a.fb_val, a.fb_ctx, a.dacc, a.F, k, pc,
                     __ldg(a.live + pc), a.with_user_bias, gwarp, nwarps, lane);
          clock.stamp(0);
          grid.sync();
          clock.stamp(5);
        }
        for (int g = bid; g < NC; g += nblocks) {
          gather_user(a.w, a.b, a.fb_idx, a.fb_val, a.seg, a.agg, a.inv, a.dacc, a.F, k, NC, c, g,
                      a.with_user_bias, smem);
        }
        clock.stamp(1);
        grid.sync();
        clock.stamp(6);
        started = true;
      }
      // the step: every read of w, b and agg; the per-context sums
      if (pipelined) {
        if (bid < G) step_unit(a, next, ((int64_t)t * G + bid) * RM + warp, lr, smem);
        const int tn = t + 1 < T ? t + 1 : 0;  // the last step of the call reads slot 0 in vain
        if (has_slot) next = load_slot(a, ((int64_t)tn * G + bid) * RM + warp);
      } else {
        for (int g = bid; g < G; g += nblocks) {
          const int64_t x = ((int64_t)t * G + g) * RM + warp;
          Slot slot;
          if (warp < RM) slot = load_slot(a, x);
          step_unit(a, slot, x, lr, smem);
          __syncthreads();
        }
      }
      clock.stamp(2);
      grid.sync();
      clock.stamp(7);
      // the delta of each context, from all of the step's sums
      for (int g = gwarp; g < NC; g += nwarps) delta_context(a, g, c, lr_fb, log_d, log_db, lane);
      clock.stamp(3);
      grid.sync();
      clock.stamp(8);
      // the apply: every write of w, b and agg
      if (role.group_warp >= 0) {
        const bool timed = a.trace != nullptr && bid == 0 && role.group_warp == 0 && lane == 0;
        const long long t0 = timed ? sgd::now_ns() : 0;
        overlap_mma(a.agg, a.delta, a.O, k, NC, c, bid, role.groups, role.group_warp, lane, smem);
        if (timed) a.trace[10] += sgd::now_ns() - t0;
      } else {
        sgd::apply_touched_rows(a.w, a.b, a.acc, N, k, role.row_warp, role.row_warps, lane,
                                decay);
      }
      clock.stamp(4);
      grid.sync();
      clock.stamp(9);
    }
  }
  const int pc = __ldg(a.cid + T - 1);
  flush_pool(a.w, a.b, a.fb_idx, a.fb_val, a.fb_ctx, a.dacc, a.F, k, pc, __ldg(a.live + pc),
             a.with_user_bias, gwarp, nwarps, lane);
  clock.stamp(0);
}

}  // namespace

// R rounds x T steps in one cooperative launch.  ``ptrs`` holds the 30
// pointers of ImfbRounds in its order (the last, trace, may be null),
// ``ints`` its 11 ints, ``floats`` its 4 floats; the grid (one block per
// SM) is written to ``grid_out``.
extern "C" int imfb_rounds(void* const* ptrs, const int* ints, const float* floats,
                           int* grid_out, void* stream) {
  ImfbRounds a;
  a.w = (float*)ptrs[0];
  a.b = (float*)ptrs[1];
  a.acc = (float*)ptrs[2];
  a.agg = (float*)ptrs[3];
  a.inv = (float*)ptrs[4];
  a.dacc = (float*)ptrs[5];
  a.delta = (float*)ptrs[6];
  a.cacc = (float*)ptrs[7];
  a.u_idx = (const int*)ptrs[8];
  a.i_idx = (const int*)ptrs[9];
  a.ctx = (const int*)ptrs[10];
  a.fb_idx = (const int*)ptrs[11];
  a.fb_ctx = (const int*)ptrs[12];
  a.seg = (const int*)ptrs[13];
  a.cid = (const int*)ptrs[14];
  a.first = (const int*)ptrs[15];
  a.live = (const int*)ptrs[16];
  a.u_val = (const float*)ptrs[17];
  a.i_val = (const float*)ptrs[18];
  a.label = (const float*)ptrs[19];
  a.weight = (const float*)ptrs[20];
  a.fb_val = (const float*)ptrs[21];
  a.O = (const float*)ptrs[22];
  a.enabled = (const float*)ptrs[23];
  a.lrs = (const float*)ptrs[24];
  a.wd_u = (const float*)ptrs[25];
  a.wd_i = (const float*)ptrs[26];
  a.wd_ub = (const float*)ptrs[27];
  a.wd_ib = (const float*)ptrs[28];
  a.trace = (long long*)ptrs[29];
  a.N = ints[0];
  a.k = ints[1];
  a.G = ints[2];
  a.RM = ints[3];
  a.D = ints[4];
  a.nseg = ints[5];
  a.T = ints[6];
  a.R = ints[7];
  a.F = ints[8];
  a.active_type = ints[9];
  a.with_user_bias = ints[10];
  a.base_score = floats[0];
  a.scale_lr_fb = floats[1];
  a.wd_fb = floats[2];
  a.wd_fbb = floats[3];
  if (a.RM < 1 || a.RM > kMaxRowsPerUnit || a.k < 1 || a.G < 1 || a.D < 1 || a.nseg < 2 ||
      a.T < 1 || a.R < 1)
    return (int)cudaErrorInvalidValue;
  // a warp per slot of a unit, at least 8 warps for the other phases
  const int warps = a.RM > kWarpsPerBlock ? a.RM : kWarpsPerBlock;
  const int threads = warps * 32;
  // shared memory: the step's present flags, the gather's partial sums or
  // the product's partial tiles, at most 8.4 KB
  size_t floats_needed = (size_t)warps * (kGatherTile + 2);
  if ((size_t)kSplit * 128 > floats_needed) floats_needed = (size_t)kSplit * 128;
  const size_t smem = sizeof(float) * floats_needed;
  const void* kernel = threads <= kThreads ? (const void*)imfb_rounds_kernel<kThreads>
                                            : (const void*)imfb_rounds_kernel<1024>;
  return sgd::launch_cooperative(kernel, a, threads, smem, grid_out, (cudaStream_t)stream);
}
