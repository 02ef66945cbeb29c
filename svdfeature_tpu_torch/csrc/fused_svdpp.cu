// SVD++ (user-group) training on Hopper: a call of R rounds x T steps as
// one persistent cooperative launch, whose phases (pool flush, aggregate
// gather, per-user step, apply) are separated by grid-wide barriers.
//
// Replaces the TPU kernel svdfeature_tpu/ops/pallas_svdpp.py::_make_kernel
// with D=0 (launched by train_rounds_svdpp_pallas), and computes what it
// computes, in f32 (the TPU kernel reads tables and payloads in bf16):
// the overlap-carried form of ops/svdpp.train_epoch_plus.  Chunk c holds G
// users; step t of it holds up to M rows of each (slot s = g*M + m).
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
//     sgd_apply (sgd_common.cuh), and in the same phase
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
// svdpp_flush, svdpp_gather and svdpp_apply stay as separate entry points
// for the stacked multi-IMFB host loop (ops/cuda_imfb.py, K3); they run
// the same __device__ bodies as the persistent kernel.
//
// Plain C interface (ctypes, svdfeature_tpu_torch/ops/_build.py): each
// entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() or the error of the
// call that failed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sgd_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kApplyBlocks = 128;  // svdpp_apply: enough lanes to sweep 8192 rows in one pass
constexpr int kGatherTile = 64;  // columns of one gather pass, two per lane
constexpr int kRegCols = 4;      // columns per lane the step keeps in registers
constexpr unsigned kFull = 0xffffffffu;

// ---- flush -------------------------------------------------------------------
// w[fb_idx[f]] += dacc[fb_block[f]] * fval[f] over the live entries of
// chunk c, a warp per entry, warps [gwarp, nwarps) of the grid (atomics:
// pool rows repeat across users)
__device__ __forceinline__ void flush_pool(float* w, float* b, const int* __restrict__ fb_idx,
                                           const float* __restrict__ fb_val,
                                           const int* __restrict__ fb_block, const float* dacc,
                                           int F, int k, int c, int live, int with_user_bias,
                                           int gwarp, int nwarps, int lane) {
  for (int f = gwarp; f < live; f += nwarps) {
    const int64_t e = (int64_t)c * F + f;
    const int row = __ldg(fb_idx + e);
    const float v = __ldg(fb_val + e);
    const float* d = dacc + (int64_t)__ldg(fb_block + e) * (k + 1);
    float* wr = w + (int64_t)row * k;
    for (int col = lane; col < k; col += 32) atomicAdd(wr + col, d[col] * v);
    if (lane == 0 && with_user_bias) atomicAdd(b + row, d[k] * v);
  }
}

// ---- gather ------------------------------------------------------------------
// agg[g] = [sum fval w[fb_idx] | sum fval b[fb_idx] | sum fval^2] over
// user g's segment of chunk c; inv[g] = 1/norm (0 for an empty pool);
// dacc[g] = 0.  The whole block works on one user: pool entries strided
// over its warps, columns in tiles of 64 (two per lane), the warps' sums
// combined in warp order through ``part`` (blockDim/32 x (kGatherTile+2)
// floats of shared memory).
__device__ __forceinline__ void gather_user(const float* w, const float* b,
                                            const int* __restrict__ fb_idx,
                                            const float* __restrict__ fb_val,
                                            const int* __restrict__ seg, float* agg, float* inv,
                                            float* dacc, int F, int k, int G, int c, int g,
                                            int with_user_bias, float* part) {
  constexpr int kPart = kGatherTile + 2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int start = __ldg(seg + (int64_t)c * (G + 1) + g);
  const int end = __ldg(seg + (int64_t)c * (G + 1) + g + 1);
  const int64_t base = (int64_t)c * F;
  for (int c0 = 0; c0 < k; c0 += kGatherTile) {
    const int ca = c0 + lane, cb = c0 + 32 + lane;
    float s0 = 0.0f, s1 = 0.0f, sb = 0.0f, sn = 0.0f;
#pragma unroll 4
    for (int f = start + warp; f < end; f += nw) {
      const float v = __ldg(fb_val + base + f);
      const int row = __ldg(fb_idx + base + f);
      const float* wr = w + (int64_t)row * k;
      if (ca < k) s0 += v * wr[ca];
      if (cb < k) s1 += v * wr[cb];
      if (c0 == 0) {  // the bias and norm columns, the same on every lane
        if (with_user_bias) sb += v * b[row];
        sn += v * v;
      }
    }
    float* p = part + warp * kPart;
    p[lane] = s0;
    p[32 + lane] = s1;
    if (lane == 0) {
      p[kGatherTile] = sb;
      p[kGatherTile + 1] = sn;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < kPart; j += blockDim.x) {
      const int col = j < kGatherTile ? c0 + j : k + (j - kGatherTile);
      if (j < kGatherTile ? col < k : c0 == 0) {
        float t = 0.0f;
        for (int q = 0; q < nw; ++q) t += part[q * kPart + j];
        agg[(int64_t)g * (k + 2) + col] = t;
        if (j == kGatherTile + 1) inv[g] = t > 0.0f ? 1.0f / fmaxf(t, 1e-30f) : 0.0f;
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < k + 1; j += blockDim.x) dacc[(int64_t)g * (k + 1) + j] = 0.0f;
}

// ---- O @ delta ---------------------------------------------------------------
// agg[v, :k+1] += sum_u O[c, v, u] delta[u, :], v, u < G.

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi): x - hi is exact in
// f32 and lo keeps its leading 11 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t* hi, uint32_t* lo) {
  *hi = to_tf32(x);
  *lo = to_tf32(x - __uint_as_float(*hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A group of kSplit warps per 16 x 8 tile of the output.  The u
// dimension goes in steps of 8, a quarter of the steps to each warp of the
// group, so that a warp has all its loads in flight at once; the warps'
// partial tiles meet in shared memory (``part``, kSplit x 128 floats) and
// the group's first warp adds them in warp order.  The groups are the last
// kSplit warps of the grid's first blocks (one group a block), so that every
// other warp can apply rows meanwhile; they meet at a named barrier of
// their own.  Fragments come straight from L2 (each tile reads 16 rows of O
// and 8 columns of delta once); entries outside G or k+1 are zeros.  The
// three products of the split run as three independent accumulator chains,
// added small terms first.
constexpr int kSplit = 4;
constexpr int kGroupBarrier = 1;  // barrier 0 is __syncthreads'

__host__ __device__ inline int overlap_tiles(int k, int G) {
  return ((G + 15) / 16) * ((k + 1 + 7) / 8);
}

// Who does what in the apply phase of a grid of nblocks blocks of nw >= 8
// warps: the first ``groups`` blocks give their last kSplit warps to the
// product, every other warp is a row warp with a dense index.
struct ApplyRoles {
  int groups;     // product groups, one in each of the first blocks
  int row_warps;  // all the row warps of the grid
  int row_warp;   // this warp's index among them, or -1 in a product group
  int group_warp; // this warp's place in its group, or -1
  __device__ __forceinline__ ApplyRoles(int k, int G, int bid, int nblocks, int warp, int nw) {
    groups = min(overlap_tiles(k, G), nblocks);
    row_warps = groups * (nw - kSplit) + (nblocks - groups) * nw;
    const bool in_group = bid < groups && warp >= nw - kSplit;
    group_warp = in_group ? warp - (nw - kSplit) : -1;
    row_warp = in_group ? -1
               : bid < groups ? bid * (nw - kSplit) + warp
                              : groups * (nw - kSplit) + (bid - groups) * nw + warp;
  }
};

__device__ __forceinline__ void group_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(kGroupBarrier), "n"(kSplit * 32) : "memory");
}

__device__ __forceinline__ void overlap_mma(float* agg, const float* delta,
                                            const float* __restrict__ O, int k, int G, int c,
                                            int group, int groups, int q, int lane, float* part) {
  const int NC = k + 1;
  const int col_tiles = (NC + 7) / 8;
  const int tiles = overlap_tiles(k, G);
  const int gid = lane >> 2, tig = lane & 3;
  const float* Oc = O + (int64_t)c * (G + 1) * (G + 1);
  // this warp's quarter of the u steps
  const int steps = (G + 7) / 8;
  const int each = (steps + kSplit - 1) / kSplit;
  const int u_begin = q * each * 8;
  const int u_end = min(G, (q + 1) * each * 8);
  for (int tile = group; tile < tiles; tile += groups) {
    const int v0 = (tile / col_tiles) * 16, j0 = (tile % col_tiles) * 8;
    const int va = v0 + gid, vb = va + 8, jb = j0 + gid;
    float dhh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float dhl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float dlh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int u0 = u_begin; u0 < u_end; u0 += 8) {
      const int ua = u0 + tig, ub = ua + 4;
      // A (16 x 8, rows v, columns u) and B (8 x 8, rows u, columns j)
      const float a[4] = {
          va < G && ua < G ? __ldg(Oc + (int64_t)va * (G + 1) + ua) : 0.0f,
          vb < G && ua < G ? __ldg(Oc + (int64_t)vb * (G + 1) + ua) : 0.0f,
          va < G && ub < G ? __ldg(Oc + (int64_t)va * (G + 1) + ub) : 0.0f,
          vb < G && ub < G ? __ldg(Oc + (int64_t)vb * (G + 1) + ub) : 0.0f};
      const float bf[2] = {ua < G && jb < NC ? delta[(int64_t)ua * NC + jb] : 0.0f,
                           ub < G && jb < NC ? delta[(int64_t)ub * NC + jb] : 0.0f};
      uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[i], &ah[i], &al[i]);
#pragma unroll
      for (int i = 0; i < 2; ++i) split_tf32(bf[i], &bh[i], &bl[i]);
      mma_tf32(dlh, al, bh);
      mma_tf32(dhl, ah, bl);
      mma_tf32(dhh, ah, bh);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) part[(q * 4 + i) * 32 + lane] = (dlh[i] + dhl[i]) + dhh[i];
    group_sync();
    if (q == 0) {
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        d[i] = part[i * 32 + lane];
#pragma unroll
        for (int w = 1; w < kSplit; ++w) d[i] += part[(w * 4 + i) * 32 + lane];
      }
      // D: rows gid and gid + 8, columns 2 tig and 2 tig + 1
      const int ja = j0 + 2 * tig;
      if (va < G && ja < NC) agg[(int64_t)va * (k + 2) + ja] += d[0];
      if (va < G && ja + 1 < NC) agg[(int64_t)va * (k + 2) + ja + 1] += d[1];
      if (vb < G && ja < NC) agg[(int64_t)vb * (k + 2) + ja] += d[2];
      if (vb < G && ja + 1 < NC) agg[(int64_t)vb * (k + 2) + ja + 1] += d[3];
    }
    group_sync();  // the partial tiles are free for the next tile
  }
}

// ---- the separate launches of the stacked multi-IMFB host loop (K3) ------------
__global__ void __launch_bounds__(kThreads) svdpp_flush_kernel(
    float* w, float* b, const int* __restrict__ fb_idx, const float* __restrict__ fb_val,
    const int* __restrict__ fb_block, const float* dacc, int F, int k, int c, int live,
    int with_user_bias) {
  flush_pool(w, b, fb_idx, fb_val, fb_block, dacc, F, k, c, live, with_user_bias,
             blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5), gridDim.x * kWarpsPerBlock,
             threadIdx.x & 31);
}

__global__ void __launch_bounds__(kThreads) svdpp_gather_kernel(
    const float* w, const float* b, const int* __restrict__ fb_idx,
    const float* __restrict__ fb_val, const int* __restrict__ seg, float* agg, float* inv,
    float* dacc, int F, int k, int G, int c, int with_user_bias) {
  __shared__ float part[kWarpsPerBlock * (kGatherTile + 2)];
  gather_user(w, b, fb_idx, fb_val, seg, agg, inv, dacc, F, k, G, c, blockIdx.x, with_user_bias,
              part);
}

// The step's row apply (a lane-parallel sweep of the touch counts with the
// per-round log tables) and agg[:, :k+1] += O[c] @ delta, by every block.
__global__ void __launch_bounds__(kThreads) svdpp_apply_kernel(
    float* w, float* b, float* acc, float* agg, const float* delta, const float* __restrict__ O,
    const float* __restrict__ log_u, const float* __restrict__ log_i,
    const float* __restrict__ log_bu, const float* __restrict__ log_bi, int N, int k, int G,
    int c, int r, int with_user_bias) {
  __shared__ float part[kSplit * 128];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const sgd::TableDecay decay{log_u, log_i, log_bu, log_bi, N, r, with_user_bias};
  const ApplyRoles role(k, G, blockIdx.x, gridDim.x, warp, kWarpsPerBlock);
  if (role.group_warp >= 0) {
    overlap_mma(agg, delta, O, k, G, c, blockIdx.x, role.groups, role.group_warp, lane, part);
  } else {
    sgd::apply_touched_rows(w, b, acc, N, k, role.row_warp, role.row_warps, lane, decay);
  }
}

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
  int N, k, G, M, SI, T, R, F, active_type, with_user_bias;
  float base_score, scale_lr_fb, wd_fb, wd_fbb;
};

// The decay factors of a row from the decay rates themselves (the wrappers
// of the host loops pass per-round log tables, sgd::TableDecay).
struct RateDecay {
  const float* wd_u;
  const float* wd_i;
  float lr, log_bu, log_bi;
  int with_user_bias;
  __device__ __forceinline__ void operator()(int n, float cu, float ci, float* fac,
                                             float* fac_b) const {
    *fac = expf(cu * sgd::log1m_rate(lr, __ldg(wd_u + n)) +
                ci * sgd::log1m_rate(lr, __ldg(wd_i + n)));
    float sb = ci * log_bi;
    if (with_user_bias) sb += cu * log_bu;
    *fac_b = expf(sb);
  }
};

__device__ __forceinline__ long long now_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// block 0's first thread adds the time since its last stamp to trace[slot]
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

// One slot's planes (item width 1 or 2).  They are inputs, never written, so
// a warp may read its next slot before the barriers that end this step.
constexpr int kMaxItems = 2;
struct Slot {
  int u, it[kMaxItems];
  float uv, iv[kMaxItems], label, weight;
};

__device__ __forceinline__ Slot load_slot(const Rounds& a, int64_t x) {
  Slot s;
  s.u = __ldg(a.u_idx + x);
  s.uv = __ldg(a.u_val + x);
#pragma unroll
  for (int e = 0; e < kMaxItems; ++e) {
    s.it[e] = e < a.SI ? __ldg(a.i_idx + x * a.SI + e) : a.N - 1;
    s.iv[e] = e < a.SI ? __ldg(a.i_val + x * a.SI + e) : 0.0f;
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
  PhaseClock clock{bid == 0 && threadIdx.x == 0 ? a.trace : nullptr, 0};
  if (clock.trace != nullptr) clock.last = now_ns();
  // the apply phase: product groups and row warps
  const ApplyRoles role(k, G, bid, nblocks, warp, nw);

  // with a block per user (G within the grid) a warp reads its next slot
  // before the step's barriers, so the planes are there when the step starts
  const bool pipelined = G <= nblocks;
  const bool has_slot = pipelined && bid < G && warp < a.M;
  Slot next;
  if (has_slot) next = load_slot(a, (int64_t)bid * a.M + warp);

  bool started = false;  // the first flush of a call is skipped
  for (int r = 0; r < a.R; ++r) {
    const float lr = __ldg(a.lrs + r);
    const float lr_fb = lr * a.scale_lr_fb;
    const float log_d = sgd::log1m_rate(lr_fb, a.wd_fb);
    const float log_db = sgd::log1m_rate(lr_fb, a.wd_fbb);
    const RateDecay decay{a.wd_u, a.wd_i, lr, sgd::log1m_rate(lr, __ldg(a.wd_ub)),
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
        const int tn = t + 1 < T ? t + 1 : 0;  // the last step of the call reads slot 0 in vain
        if (has_slot) next = load_slot(a, ((int64_t)tn * G + bid) * a.M + warp);
      } else {
        for (int g = bid; g < G; g += nblocks) {
          Slot slot;
          if (warp < a.M) slot = load_slot(a, ((int64_t)t * G + g) * a.M + warp);
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
        const long long t0 = timed ? now_ns() : 0;
        overlap_mma(a.agg, a.delta, a.O, k, G, c, bid, role.groups, role.group_warp, lane, smem);
        if (timed) a.trace[8] += now_ns() - t0;
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

// The grid of the cooperative launch: one block per SM, if the device can
// co-schedule that (no fallback: otherwise the call is refused).  Asked
// once per (kernel, device, threads, shared memory) and kept.
template <int kMaxThreads>
int rounds_grid(int threads, size_t smem, int* grid) {
  static int kept_dev = -1, kept_threads = 0, kept_grid = 0;
  static size_t kept_smem = 0;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (kept_dev == dev && kept_threads == threads && kept_smem == smem) {
    *grid = kept_grid;
    return 0;
  }
  auto kernel = svdpp_rounds_kernel<kMaxThreads>;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return (int)err;
  if (!coop || per_sm < 1 || sms < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  kept_dev = dev;
  kept_threads = threads;
  kept_smem = smem;
  kept_grid = sms;
  *grid = sms;
  return 0;
}

template <int kMaxThreads>
int launch_rounds(const Rounds& a, int threads, size_t smem, int* grid_out, cudaStream_t s) {
  int grid = 0;
  const int refused = rounds_grid<kMaxThreads>(threads, smem, &grid);
  if (refused) return refused;
  *grid_out = grid;
  void* args[] = {(void*)&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)svdpp_rounds_kernel<kMaxThreads>, dim3(grid), dim3(threads), args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
  svdpp_gather_kernel<<<G, kThreads, 0, (cudaStream_t)stream>>>(
      w, b, fb_idx, fb_val, seg, agg, inv, dacc, F, k, G, c, with_user_bias);
  return (int)cudaGetLastError();
}

extern "C" int svdpp_apply(float* w, float* b, float* acc, float* agg, const float* delta,
                           const float* O, const float* log_u, const float* log_i,
                           const float* log_bu, const float* log_bi, int N, int k, int G,
                           int c, int r, int with_user_bias, void* stream) {
  svdpp_apply_kernel<<<kApplyBlocks, kThreads, 0, (cudaStream_t)stream>>>(
      w, b, acc, agg, delta, O, log_u, log_i, log_bu, log_bi, N, k, G, c, r, with_user_bias);
  return (int)cudaGetLastError();
}

// R rounds x T steps in one cooperative launch.  ``ptrs`` holds the 27
// pointers of Rounds in its order (the last, trace, may be null), ``ints``
// its 10 ints, ``floats`` its 4 floats; the grid (one block per SM) is
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
  a.base_score = floats[0];
  a.scale_lr_fb = floats[1];
  a.wd_fb = floats[2];
  a.wd_fbb = floats[3];
  if (a.M < 1 || a.M > 32 || a.k < 1 || a.G < 1 || a.T < 1 || a.R < 1 || a.SI < 1 ||
      a.SI > kMaxItems)
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
  cudaStream_t s = (cudaStream_t)stream;
  if (threads <= kThreads) return launch_rounds<kThreads>(a, threads, smem, grid_out, s);
  return launch_rounds<1024>(a, threads, smem, grid_out, s);
}
