// SVD++ (user-group) training on Hopper: a call of R rounds x T steps as
// one persistent cooperative launch, whose phases (pool flush, aggregate
// gather, per-user step, apply) are separated by grid-wide barriers.
//
// Replaces the TPU kernel svdfeature_tpu/ops/pallas_svdpp.py::_make_kernel
// with D=0 (launched by train_rounds_svdpp_pallas), and computes what it
// computes, in f32 (the TPU kernel reads tables and payloads in bf16):
// the overlap-carried form of ops/svdpp.train_epoch_plus.  Chunk c holds G
// users; step t of it holds up to M rows of each (slot s = g*M + m).  The
// user and item planes may hold one epoch per round ([R*T, G*M]: pairwise-
// rank epochs sampled afresh for every round, the TPU kernel's round_spec),
// the labels, weights, pools and overlaps staying the epoch's.
//   * chunk start (first step of a chunk): the flush adds the previous
//     chunk's accumulated per-user deltas to its pool rows,
//     w[fb_idx] += dacc[fb_block] * fval (and b with user bias); then the
//     gather forms the new chunk's agg[g] = [sum fval w[fb_idx] |
//     sum fval b[fb_idx] | sum fval^2], inv[g] = 1/norm, dacc[g] = 0;
//   * step: p_u = u_val w[u] + agg[g, :k], p_i = sum_SI i_val w[i], the
//     score with its biases, err; the u/i row updates go by atomicAdd
//     into acc[N, k+3] = [dw | db | cu | ci] (K1's layout); the per-user
//     sums of err p_i, err, present rows and |p_i|^2 give the damped
//     feedback step delta[g] (rows_per_user > 1), dacc[g] += delta[g];
//   * apply: every touched row w = (w + dw) * exp(touch decay), as K1's
//     apply (sgd::apply_touched_rows, sgd_common.cuh), and in the same phase
//     agg[v, :k+1] += sum_u O[c, v, u] delta[u] (the TPU kernel's in-body
//     O @ delta).
// The TPU kernel is one pallas_call over a sequential R x T grid.  Here
// the same shape is svdpp_rounds: a grid of co-resident blocks, one per SM,
// walks rounds, steps and chunk starts itself (chunk ids, chunk-start flags
// and live pool entries come as int32 planes) and calls
// cooperative_groups::this_grid().sync() where a dependency stands:
// flush -> gather at a chunk start, gather -> step, step (all reads of w,
// b, agg) -> apply (all writes), apply -> next step.  Every read of a step
// precedes any write of it, as the reference trajectory needs.  A block
// strides over users when G exceeds the grid.  The first flush of a call is
// skipped and one final flush is added.
//
// What bounds it on the card: latency, not bytes or arithmetic.  At the
// implicitFeedback band setting (G=128, M=8, k=64, N=4308) the tables
// (1.1 MB), a round's step planes (3.9 MB), the pools and the overlap
// matrices sit in L2; O @ delta is 2 G (G+1) (k+1) = 2.1 MFLOP a step, a
// fraction of a microsecond at the f32 rate, and a step's dependent chain
// (gather rows -> dot -> scatter | barrier | counts -> rows | barrier) is a
// handful of L2 round trips and two grid barriers.  What the design does
// about it:
//   * one launch per call: no host work and no launch boundary between
//     steps (the host-launched form spent more time between kernels than in
//     them);
//   * the step keeps p_u / p_i of its columns in registers between the dot
//     and the scatter instead of gathering the rows twice, and with a block
//     per user a warp reads its next slot's planes (inputs, never written)
//     ahead of the step's barriers;
//   * O @ delta on the tensor cores while the other warps apply rows: four
//     warps per 16 x 8 output tile, each a quarter of u, mma.sync m16n8k8
//     TF32 with the exact split a = hi + lo, three products hi*hi + hi*lo +
//     lo*hi accumulated in f32 (about 2^-21 relative; one-pass TF32 would
//     keep three decimal digits and is not used), the quarters added in
//     warp order, so the result does not depend on timing.  (An f32 FMA
//     form, a block per output row with delta staged in shared memory,
//     measured 2.9 us a step slower at the band setting and was dropped.)
//   * the row apply as a lane-parallel sweep of the N rows' touch counts,
//     four touched rows in flight per warp (sgd::apply_touched_rows).  (A
//     list of touched rows built by the step with one atomicExch per slot
//     entry measured the same within noise and was dropped.)
// Per-user reductions need no atomics: a block reduces a user's M warps in
// shared memory, and a user's pool entries are contiguous
// (data/batching_plus.py), so a block sums its own segment
// [seg[g], seg[g+1]).  Pool rows are shared by users, so the flush uses
// atomics.  Slots whose index is the dummy row N-1 (padding) scatter
// nothing: that row is zeroed at the start of the call and never touched.
//
// The flush, gather and O @ delta bodies live in feedback_common.cuh: the
// stacked multi-IMFB kernel (fused_imfb.cu, K3) runs them too.
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

// ---- the persistent kernel -------------------------------------------------------
struct Rounds {
  // the tables (updated in place) and the call's scratch, all written
  // during the launch: never read through the read-only path
  float *w, *b, *acc, *agg, *inv, *dacc, *delta;
  // inputs, read only
  const int *u_idx, *i_idx, *fb_idx, *fb_block, *seg, *cid, *first, *live;
  const float *u_val, *i_val, *label, *weight, *fb_val, *O;
  const float *lrs, *wd_u, *wd_i, *wd_ub, *wd_ib;
  // null, or 9 sums of nanoseconds: as block 0's first thread sees them, its
  // own work in the flush, gather, step and apply phases [0..3], then the
  // barrier after each [4..7] (which waits for the slowest block); and the
  // apply phase's product as block 0's product group sees it [8]
  long long* trace;
  // UR: the rounds of the user and item planes, 1 (every round reads the
  // same) or R (per-round planes, [R*T, G*M])
  int N, k, G, M, SI, T, R, F, active_type, with_user_bias, UR;
  float base_score, scale_lr_fb, wd_fb, wd_fbb;
};

// One slot's planes (item width 1 or 2).  They are inputs, never written, so
// a warp may read its next slot before the barriers that end this step.
constexpr int kMaxItems = 2;
struct Slot {
  int u, it[kMaxItems];
  float uv, iv[kMaxItems], label, weight;
};

// Slot x (of the T*G*M of a round) in round r.  With per-round planes
// (UR == R: a pair epoch sampled afresh for every round) the user and item
// planes of round r start at r*T*G*M; label and weight are the epoch's.
__device__ __forceinline__ Slot load_slot(const Rounds& a, int64_t x, int r) {
  Slot s;
  const int64_t xu = x + (a.UR > 1 ? (int64_t)r * a.T * a.G * a.M : 0);
  s.u = __ldg(a.u_idx + xu);
  s.uv = __ldg(a.u_val + xu);
#pragma unroll
  for (int e = 0; e < kMaxItems; ++e) {
    s.it[e] = e < a.SI ? __ldg(a.i_idx + xu * a.SI + e) : a.N - 1;
    s.iv[e] = e < a.SI ? __ldg(a.i_val + xu * a.SI + e) : 0.0f;
  }
  s.label = __ldg(a.label + x);
  s.weight = __ldg(a.weight + x);
  return s;
}

// User g's step: warp m < M takes slot g*M + m (its planes in ``slot``);
// then the whole block forms the user's feedback step.  Shared memory:
// red[M][k] (err * p_i), then err, present and |p_i|^2 per slot.
__device__ __forceinline__ void step_user(const Rounds& a, int g, const Slot& slot, float lr,
                                          float lr_fb, float log_d, float log_db, float* smem) {
  const int N = a.N, k = a.k, M = a.M, SI = a.SI;
  float* red = smem;              // [M][k]
  float* s_err = red + M * k;     // [M]
  float* s_present = s_err + M;   // [M]
  float* s_pip2 = s_present + M;  // [M]
  const int m = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* ag = a.agg + (int64_t)g * (k + 2);
  if (m < M) {
    const int u = slot.u;
    const float uv = slot.uv;
    const float* wu = a.w + (int64_t)u * k;

    // p_u and p_i of column c
    auto column = [&](int c, float* pu, float* pi) {
      *pu = uv * wu[c] + ag[c];
      float s = 0.0f;
#pragma unroll
      for (int e = 0; e < kMaxItems; ++e) {
        if (e < SI) s += slot.iv[e] * a.w[(int64_t)slot.it[e] * k + c];
      }
      *pi = s;
    };
    float pu_r[kRegCols], pi_r[kRegCols];
    float dot = 0.0f;
#pragma unroll
    for (int q = 0; q < kRegCols; ++q) {
      const int c = lane + 32 * q;
      pu_r[q] = 0.0f;
      pi_r[q] = 0.0f;
      if (c < k) {
        column(c, &pu_r[q], &pi_r[q]);
        dot += pu_r[q] * pi_r[q];
      }
    }
    for (int c = lane + 32 * kRegCols; c < k; c += 32) {
      float pu, pi;
      column(c, &pu, &pi);
      dot += pu * pi;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);

    // every lane forms the same score, in the plain version's order
    float score = a.base_score;
#pragma unroll
    for (int e = 0; e < kMaxItems; ++e) {
      if (e < SI) score += slot.iv[e] * a.b[slot.it[e]];
    }
    if (a.with_user_bias) score += uv * a.b[u] + ag[k];
    score += dot;
    const float present = slot.weight;
    const float err = sgd::active_grad(score, slot.label, a.active_type) * present;
    const float lr_err = lr * err;
    const float coef_u = lr_err * uv;

    const int ld = k + 3;
    float* au = a.acc + (int64_t)u * ld;
    float pip2 = 0.0f;
    auto scatter = [&](int c, float pu, float pi) {
      if (u != N - 1) atomicAdd(au + c, coef_u * pi);
#pragma unroll
      for (int e = 0; e < kMaxItems; ++e) {
        const int row = slot.it[e];
        if (e < SI && row != N - 1)
          atomicAdd(a.acc + (int64_t)row * ld + c, lr_err * slot.iv[e] * pu);
      }
      red[m * k + c] = err * pi;
      pip2 += pi * pi;
    };
#pragma unroll
    for (int q = 0; q < kRegCols; ++q) {
      const int c = lane + 32 * q;
      if (c < k) scatter(c, pu_r[q], pi_r[q]);
    }
    for (int c = lane + 32 * kRegCols; c < k; c += 32) {
      float pu, pi;
      column(c, &pu, &pi);
      scatter(c, pu, pi);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) pip2 += __shfl_xor_sync(kFull, pip2, o);
    if (lane == 0) {
      if (u != N - 1) {
        if (a.with_user_bias) atomicAdd(au + k, coef_u);
        atomicAdd(au + k + 1, 1.0f);
      }
#pragma unroll
      for (int e = 0; e < kMaxItems; ++e) {
        const int row = slot.it[e];
        if (e >= SI || row == N - 1) continue;
        float* ai = a.acc + (int64_t)row * ld;
        atomicAdd(ai + k, lr_err * slot.iv[e]);
        atomicAdd(ai + k + 2, 1.0f);
      }
      s_err[m] = err;
      s_present[m] = present;
      s_pip2[m] = pip2;
    }
  }
  __syncthreads();

  // the user's feedback step (train_epoch_plus body, same formulas)
  float m_g = 0.0f, err_g = 0.0f, pip2_g = 0.0f;
  for (int j = 0; j < M; ++j) {
    m_g += s_present[j];
    err_g += s_err[j];
    pip2_g += s_pip2[j];
  }
  const float norm = ag[k + 1];
  const float invg = a.inv[g];
  float damp_pi = 1.0f, damp_b = 1.0f;
  if (M > 1) {
    // implicit damping of the M-wide within-user Jacobi step
    const float frac = m_g > 0.0f ? (m_g - 1.0f) / fmaxf(m_g, 1.0f) : 0.0f;
    damp_pi = 1.0f + lr_fb * norm * pip2_g * frac;
    damp_b = 1.0f + lr_fb * norm * (m_g > 0.0f ? m_g - 1.0f : 0.0f);
  }
  const float powd = expf(m_g * log_d) - 1.0f;  // d^m_g - 1
  const float powdb = expf(m_g * log_db) - 1.0f;
  float* dl = a.delta + (int64_t)g * (k + 1);
  float* da = a.dacc + (int64_t)g * (k + 1);
  for (int j = threadIdx.x; j < k + 1; j += blockDim.x) {
    float dv;
    if (j < k) {
      float errpi = 0.0f;
      for (int mm = 0; mm < M; ++mm) errpi += red[mm * k + j];
      errpi = errpi / damp_pi;
      dv = (ag[j] * powd + lr_fb * norm * errpi) * invg;
    } else {
      dv = a.with_user_bias ? (ag[k] * powdb + lr_fb * norm * (err_g / damp_b)) * invg : 0.0f;
    }
    dl[j] = dv;
    da[j] += dv;
  }
}

template <int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) svdpp_rounds_kernel(const Rounds a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int bid = blockIdx.x, nblocks = gridDim.x;
  const int gwarp = bid * nw + warp, nwarps = nblocks * nw;
  const int N = a.N, k = a.k, G = a.G, T = a.T;

  // the dummy row stays exactly 0 (padding slots scatter nothing into it);
  // nothing reads it before the first step, which a barrier precedes
  if (bid == 0) {
    for (int j = threadIdx.x; j < k; j += blockDim.x) a.w[(int64_t)(N - 1) * k + j] = 0.0f;
    if (threadIdx.x == 0) a.b[N - 1] = 0.0f;
  }
  sgd::PhaseClock clock{bid == 0 && threadIdx.x == 0 ? a.trace : nullptr, 0};
  if (clock.trace != nullptr) clock.last = sgd::now_ns();
  // the apply phase: product groups and row warps
  const ApplyRoles role(k, G, bid, nblocks, warp, nw);

  // with a block per user (G within the grid) a warp reads its next slot
  // before the step's barriers, so the planes are there when the step starts
  const bool pipelined = G <= nblocks;
  const bool has_slot = pipelined && bid < G && warp < a.M;
  Slot next;
  if (has_slot) next = load_slot(a, (int64_t)bid * a.M + warp, 0);

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
          flush_pool(a.w, a.b, a.fb_idx, a.fb_val, a.fb_block, a.dacc, a.F, k, pc,
                     __ldg(a.live + pc), a.with_user_bias, gwarp, nwarps, lane);
          clock.stamp(0);
          grid.sync();
          clock.stamp(4);
        }
        for (int g = bid; g < G; g += nblocks) {
          gather_user(a.w, a.b, a.fb_idx, a.fb_val, a.seg, a.agg, a.inv, a.dacc, a.F, k, G, c, g,
                      a.with_user_bias, smem);
        }
        clock.stamp(1);
        grid.sync();
        clock.stamp(5);
        started = true;
      }
      // the step: every read of w, b and agg
      if (pipelined) {
        if (bid < G) step_user(a, bid, next, lr, lr_fb, log_d, log_db, smem);
        // the next step, in this round or the next; the last step of the
        // call reads step 0 of round 0 in vain
        const int tn = t + 1 < T ? t + 1 : 0;
        const int rn = t + 1 < T ? r : (r + 1 < a.R ? r + 1 : 0);
        if (has_slot) next = load_slot(a, ((int64_t)tn * G + bid) * a.M + warp, rn);
      } else {
        for (int g = bid; g < G; g += nblocks) {
          Slot slot;
          if (warp < a.M) slot = load_slot(a, ((int64_t)t * G + g) * a.M + warp, r);
          step_user(a, g, slot, lr, lr_fb, log_d, log_db, smem);
          __syncthreads();
        }
      }
      clock.stamp(2);
      grid.sync();
      clock.stamp(6);
      // the apply: every write
      if (role.group_warp >= 0) {
        const bool timed = a.trace != nullptr && bid == 0 && role.group_warp == 0 && lane == 0;
        const long long t0 = timed ? sgd::now_ns() : 0;
        overlap_mma(a.agg, a.delta, a.O, k, G, c, bid, role.groups, role.group_warp, lane, smem);
        if (timed) a.trace[8] += sgd::now_ns() - t0;
      } else {
        sgd::apply_touched_rows(a.w, a.b, a.acc, N, k, role.row_warp, role.row_warps, lane,
                                decay);
      }
      clock.stamp(3);
      grid.sync();
      clock.stamp(7);
    }
  }
  const int pc = __ldg(a.cid + T - 1);
  flush_pool(a.w, a.b, a.fb_idx, a.fb_val, a.fb_block, a.dacc, a.F, k, pc, __ldg(a.live + pc),
             a.with_user_bias, gwarp, nwarps, lane);
  clock.stamp(0);
}

}  // namespace

// R rounds x T steps in one cooperative launch.  ``ptrs`` holds the 27
// pointers of Rounds in its order (the last, trace, may be null), ``ints``
// its 11 ints, ``floats`` its 4 floats; the grid (one block per SM) is
// written to ``grid_out``.
extern "C" int svdpp_rounds(void* const* ptrs, const int* ints, const float* floats,
                            int* grid_out, void* stream) {
  Rounds a;
  a.w = (float*)ptrs[0];
  a.b = (float*)ptrs[1];
  a.acc = (float*)ptrs[2];
  a.agg = (float*)ptrs[3];
  a.inv = (float*)ptrs[4];
  a.dacc = (float*)ptrs[5];
  a.delta = (float*)ptrs[6];
  a.u_idx = (const int*)ptrs[7];
  a.i_idx = (const int*)ptrs[8];
  a.fb_idx = (const int*)ptrs[9];
  a.fb_block = (const int*)ptrs[10];
  a.seg = (const int*)ptrs[11];
  a.cid = (const int*)ptrs[12];
  a.first = (const int*)ptrs[13];
  a.live = (const int*)ptrs[14];
  a.u_val = (const float*)ptrs[15];
  a.i_val = (const float*)ptrs[16];
  a.label = (const float*)ptrs[17];
  a.weight = (const float*)ptrs[18];
  a.fb_val = (const float*)ptrs[19];
  a.O = (const float*)ptrs[20];
  a.lrs = (const float*)ptrs[21];
  a.wd_u = (const float*)ptrs[22];
  a.wd_i = (const float*)ptrs[23];
  a.wd_ub = (const float*)ptrs[24];
  a.wd_ib = (const float*)ptrs[25];
  a.trace = (long long*)ptrs[26];
  a.N = ints[0];
  a.k = ints[1];
  a.G = ints[2];
  a.M = ints[3];
  a.SI = ints[4];
  a.T = ints[5];
  a.R = ints[6];
  a.F = ints[7];
  a.active_type = ints[8];
  a.with_user_bias = ints[9];
  a.UR = ints[10];
  a.base_score = floats[0];
  a.scale_lr_fb = floats[1];
  a.wd_fb = floats[2];
  a.wd_fbb = floats[3];
  if (a.M < 1 || a.M > 32 || a.k < 1 || a.G < 1 || a.T < 1 || a.R < 1 || a.SI < 1 ||
      a.SI > kMaxItems || (a.UR != 1 && a.UR != a.R))
    return (int)cudaErrorInvalidValue;
  // a warp per slot of a user, at least 8 warps for the other phases
  const int warps = a.M > kWarpsPerBlock ? a.M : kWarpsPerBlock;
  const int threads = warps * 32;
  // shared memory, under the 48 KB that need no opt-in (the wrapper's gate
  // caps the step's part)
  size_t floats_needed = (size_t)a.M * (a.k + 3);                          // the step
  const size_t gather = (size_t)warps * (kGatherTile + 2);                 // the gather
  if (gather > floats_needed) floats_needed = gather;
  const size_t product = (size_t)kSplit * 128;                             // the partial tiles
  if (product > floats_needed) floats_needed = product;
  const size_t smem = sizeof(float) * floats_needed;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const void* kernel = threads <= kThreads ? (const void*)svdpp_rounds_kernel<kThreads>
                                            : (const void*)svdpp_rounds_kernel<1024>;
  return sgd::launch_cooperative(kernel, a, threads, smem, grid_out, (cudaStream_t)stream);
}
