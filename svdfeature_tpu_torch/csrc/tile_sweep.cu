// The tile-sweep update of the big-table route on Hopper (K4): form each
// touched row's entries from the step's factors, sum them, and apply the
// step's regularization to that row, in place, one launch per training step.
//
// Replaces the TPU kernel svdfeature_tpu/ops/tile_sweep.py
// ::_make_sweep_kernel (launched by sweep_update, its pallas_call at :321)
// and computes what it computes.  The TPU kernel walks the pack-time plan
// cell by cell in tile order, lands a cell's [1024, W] payload
// [dw | db | cu | ci] on its [2048, W] tile with a one-hot MXU matmul
// (Mosaic has no row gather), accumulates the tile in VMEM scratch and
// applies the math on the tile's last visit.  On the H100 a 2048 x 128 f32
// tile is 1 MiB against 227 KB of shared memory per block, and the one-hot
// product only ever stood in for a gather, so the design is a segmented
// reduction over the plan's runs (each touched row's entries, contiguous in
// plan order; found once at pack time by ops/tile_sweep.attach_sweep_runs).
//
// What bounds it on the card: bytes (the step's factors p_u / p_i, read
// once per entry, and each touched row read and written once), reached
// only if every load of a run is in flight at once.  The design:
//   * no payload.  An entry e < B*Su is a user entry of example e / Su:
//     dw = coef_u[e] * p_i[e / Su], db = coef_u[e] (0 without user bias),
//     cu = 1; any other is an item entry: dw = coef_i * p_u, db = coef_i,
//     ci = 1.  The kernel forms them from p_u, p_i (256-byte rows at k=64)
//     and the coefficients, so the [E, k+3] payload is never written or
//     read back (its rows were 268 bytes, never 16-byte aligned).
//   * one 16-byte record per run, (first plan position, end, table row,
//     piece slot), so one load brings a run's bounds and its row; the row
//     (float4 loads), its ref bits, its two decay rates and the run's first
//     16 plan sources are then issued together, before any entry load.
//   * 16 lanes per run, each holding 4 columns of a 64-column chunk as a
//     float4 (k <= 256: up to 4 chunks); db, cu, ci are scalars every lane
//     keeps.  A warp holds two runs; entries are read up to 8 at a time
//     ahead of their adds, which stay in plan order (deterministic, no
//     atomics).
//   * a wider row (k > 256) is swept in passes of 256 columns by a kernel
//     of its own, so the registers of the k <= 256 kernels stay as they
//     are: each pass sums the run's entries over its columns and writes
//     them (a piece's partials go to their columns of the slot), the bias
//     and the ref bits once at the end.  reg_method 2 scales the whole row
//     onto its ball: its passes write the unscaled row and sum its
//     squares, and a last walk over the lane's own columns scales them.
//   * long runs are cut at pack time into pieces (runs of a popular item:
//     thousands of entries in skewed data; pieces of about sqrt(n) of a
//     run's n entries, so that a piece and the run's finish take about
//     equally long).  Each piece writes its partial
//     sums to a slot of a scratch buffer; the piece that arrives last (an
//     integer counter per run, left at 0 again) adds the partials in slot
//     order and finishes the row.  Pieces never write the row, and the sums
//     do not depend on which piece arrives last.
// After the sums, per touched row: reg_method 0-5 (the lazy modes through
// the int32 ref bits), the nonnegative clamps, the bias decay, as before.
//
// The ref column holds int32 sample counts as raw bits; below 2^23 those
// bits are denormal floats, so they are only ever moved as ints here (and
// the build keeps denormals: no -ftz / fast math).
//
// Plain C interface (ctypes, svdfeature_tpu_torch/ops/_build.py): the
// entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 16;  // lanes per run
constexpr int kThreads = 256;
constexpr int kGroupsPerBlock = kThreads / kGroup;
// entries whose loads are issued before their adds, by 64-column chunks
// held per lane (registers: kAhead * NC float4s; deeper runs of loads cost
// more in occupancy than they gain, measured at bigTable's batch)
template <int NC>
constexpr int kAhead = NC == 1 ? 4 : 2;
// blocks per SM the registers must allow: 64 registers a thread, half the
// SM's threads in flight (the kernel waits on memory, not on arithmetic)
constexpr int kMinBlocks = 4;
constexpr int kPartialsAhead = 8;  // partial sums read before their adds
constexpr int kPassChunks = 4;     // 64-column chunks a pass of a wide row holds
// partial sums the wide kernel reads before their adds: its registers go to
// a pass's chunks (8 ahead spilled 640 bytes a thread there)
constexpr int kWidePartialsAhead = 2;

struct SweepArgs {
  float* w;              // [n_pad, W] augmented table, updated in place
  const int4* runs;      // [n_runs] (p0, p1, row, slot or -1)
  const int2* pieces;    // [n_slots] (first slot of the piece's run, pieces)
  const int* src;        // [n_plan] entry of each plan position, E = padding
  const float* p_u;      // [B, k]
  const float* p_i;      // [B, k]
  const float* coef_u;   // [B * Su]
  const float* coef_i;   // [B * Si]
  const float* wdu;      // [n_pad]
  const float* wdi;      // [n_pad]
  const float* scal;     // lr, wd_user_bias, wd_item_bias, 0
  const int* stepi;      // the pre-batch sample counter
  float* part;           // [n_slots, 64 * ceil(k / 64) + 4] partial sums of pieces
  int* count;            // [n_slots] arrivals per run (at its first slot), left at 0
  int n_runs, n_slots, n_plan, B, Su, Si, n_pad, W, k;
  int reg_method, user_nonneg, item_nonneg, with_user_bias;
};

__device__ __forceinline__ float log1m(float v) { return logf(fmaxf(1.0f - v, 1e-38f)); }

// sign(w) * max(|w| - lam, 0)
__device__ __forceinline__ float soft(float w, float lam) {
  const float m = fmaxf(fabsf(w) - lam, 0.0f);
  return w > 0.0f ? m : (w < 0.0f ? -m : 0.0f);
}

__device__ __forceinline__ float& comp(float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// 4 consecutive columns of a k-wide row from column c (0 past k)
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* row, int c, int k) {
  if (VEC) return c < k ? __ldg(reinterpret_cast<const float4*>(row + c)) : make_float4(0, 0, 0, 0);
  float4 v = make_float4(0, 0, 0, 0);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < k) comp(v, j) = __ldg(row + c + j);
  return v;
}

template <int NC>
struct Sums {
  float4 dw[NC];
  float db, cu, ci;
};

template <int NC>
__device__ __forceinline__ void clear(Sums<NC>& a) {
#pragma unroll
  for (int q = 0; q < NC; ++q) a.dw[q] = make_float4(0, 0, 0, 0);
  a.db = a.cu = a.ci = 0.0f;
}

// The sums of plan positions [p0, p1), in plan order, over the NC chunks
// from column c0.  ``first`` holds src[p0 + g] of this lane g (loaded with
// the run's record).
template <int NC, bool VEC>
__device__ __forceinline__ void sum_entries(Sums<NC>& a, const SweepArgs& A, int p0, int p1,
                                            int first, int g, unsigned gmask, int lane0,
                                            int c0) {
  const int BSu = A.B * A.Su;
  const int E = BSu + A.B * A.Si;
  for (int base = p0; base < p1; base += kGroup) {
    const int n = min(kGroup, p1 - base);
    const int mine = base == p0 ? first : (g < n ? __ldg(A.src + base + g) : E);
    constexpr int ahead = kAhead<NC>;
    for (int j = 0; j < n; j += ahead) {
      float c[ahead];
      bool user[ahead];
      float4 v[ahead][NC];
#pragma unroll
      for (int u = 0; u < ahead; ++u) {
        const int s = __shfl_sync(gmask, mine, lane0 + min(j + u, kGroup - 1));
        const bool live = j + u < n && s != E;
        if (j + u < n && (s < 0 || s > E)) __trap();
        user[u] = s < BSu;
        c[u] = 0.0f;
#pragma unroll
        for (int q = 0; q < NC; ++q) v[u][q] = make_float4(0, 0, 0, 0);
        if (live) {
          const int ex = user[u] ? s / A.Su : (s - BSu) / A.Si;
          c[u] = __ldg(user[u] ? A.coef_u + s : A.coef_i + (s - BSu));
          const float* row = (user[u] ? A.p_i : A.p_u) + (int64_t)ex * A.k;
#pragma unroll
          for (int q = 0; q < NC; ++q) v[u][q] = load4<VEC>(row, c0 + 64 * q + 4 * g, A.k);
        }
        // padding adds nothing, not even a count
        if (!live) user[u] = false;
        else if (user[u]) a.cu += 1.0f;
        else a.ci += 1.0f;
      }
#pragma unroll
      for (int u = 0; u < ahead; ++u) {
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          a.dw[q].x += c[u] * v[u][q].x;
          a.dw[q].y += c[u] * v[u][q].y;
          a.dw[q].z += c[u] * v[u][q].z;
          a.dw[q].w += c[u] * v[u][q].w;
        }
        a.db += (user[u] && !A.with_user_bias) ? 0.0f : c[u];
      }
    }
  }
}

// The last-visit math of the TPU kernel on one touched row (x: its factor
// columns held by this lane, xb its bias, ref its lazy counter), written in
// place.
template <int NC, bool VEC>
__device__ __forceinline__ void finish_row(const Sums<NC>& a, const SweepArgs& A, int64_t row,
                                           const float4 (&x)[NC], float xb, int ref, float wu,
                                           float wi, int g, unsigned gmask) {
  const float cu = a.cu, ci = a.ci;
  if (!((cu + ci) > 0.0f)) return;  // untouched: the row stays as it is
  const int k = A.k;
  const int m = A.reg_method;
  const float lr = A.scal[0];
  const int step = A.stepi[0];
  float4 nw[NC];
  if (m >= 4) {
    const float el = (float)(step - ref);
    const float lam = lr * (cu > 0.0f ? wu : wi);
    const float fac = expf(el * log1m(lam));
#pragma unroll
    for (int q = 0; q < NC; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xv = comp(x[q], j);
        comp(nw[q], j) = (m == 4 ? xv * fac : soft(xv, lam * el)) + comp(a.dw[q], j);
      }
  } else {
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      nw[q].x = x[q].x + a.dw[q].x;
      nw[q].y = x[q].y + a.dw[q].y;
      nw[q].z = x[q].z + a.dw[q].z;
      nw[q].w = x[q].w + a.dw[q].w;
    }
    if (m == 2) {
      float sq = 0.0f;  // columns past k hold 0
#pragma unroll
      for (int q = 0; q < NC; ++q)
        sq += nw[q].x * nw[q].x + nw[q].y * nw[q].y + nw[q].z * nw[q].z + nw[q].w * nw[q].w;
#pragma unroll
      for (int o = kGroup / 2; o > 0; o >>= 1) sq += __shfl_xor_sync(gmask, sq, o);
      const float wd_row = cu > 0.0f ? wu : wi;
      const float scale = sq > wd_row ? sqrtf(wd_row / fmaxf(sq, 1e-30f)) : 1.0f;
#pragma unroll
      for (int q = 0; q < NC; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j) comp(nw[q], j) *= scale;
    } else {
      const float fac0 = expf(cu * log1m(lr * wu) + ci * log1m(lr * wi));
      const float thr1 = lr * (wu * cu + wi * ci);
      const float thr3 = lr * wu * cu;
      const float fac3 = expf(ci * log1m(lr * wi));
#pragma unroll
      for (int q = 0; q < NC; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float& v = comp(nw[q], j);
          if (m == 0) v *= fac0;
          else if (m == 1) v = soft(v, thr1);
          else v = soft(v, thr3) * fac3;
        }
    }
  }
#pragma unroll
  for (int q = 0; q < NC; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float& v = comp(nw[q], j);
      if (A.user_nonneg && cu > 0.0f) v = fmaxf(v, 0.0f);
      if (A.item_nonneg && ci > 0.0f) v = fmaxf(v, 0.0f);
    }
  float logb = ci * log1m(lr * A.scal[2]);
  if (A.with_user_bias) logb += cu * log1m(lr * A.scal[1]);
  const float nb = (xb + a.db) * expf(logb);

  // every lane of the group has read the row before any lane writes it
  __syncwarp(gmask);
  float* xr = A.w + row * A.W;
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int c = 64 * q + 4 * g;
    if (VEC) {
      if (c < k) *reinterpret_cast<float4*>(xr + c) = nw[q];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < k) xr[c + j] = comp(nw[q], j);
    }
  }
  if (g == 0) {
    xr[k] = nb;
    if (m >= 4) reinterpret_cast<int*>(xr)[k + 1] = step;
  }
}

template <int NC, bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks) sweep_apply_kernel(const SweepArgs A) {
  const int lane = threadIdx.x & 31;
  const int g = lane & (kGroup - 1);
  const int lane0 = lane & kGroup;  // the group's first lane in the warp
  const unsigned gmask = 0xffffu << lane0;
  const int t = blockIdx.x * kGroupsPerBlock + (threadIdx.x / kGroup);
  if (t >= A.n_runs) return;

  // one wave: the run's record, then its row, ref, decay rates and first
  // 16 plan sources, all independent of each other
  const int4 rec = __ldg(A.runs + t);
  const int p0 = rec.x, p1 = rec.y, slot = rec.w;
  if (p0 >= p1) return;  // an empty run pads the batch's run list
  const int64_t row = rec.z;
  if (p0 < 0 || p1 > A.n_plan || row < 0 || row >= A.n_pad || slot < -1 || slot >= A.n_slots)
    __trap();
  const int BSu = A.B * A.Su;
  const int E = BSu + A.B * A.Si;
  const int first = g < p1 - p0 ? __ldg(A.src + p0 + g) : E;
  const float* xr = A.w + row * A.W;
  float4 x[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int c = 64 * q + 4 * g;
    if (VEC) {
      x[q] = c < A.k ? *reinterpret_cast<const float4*>(xr + c) : make_float4(0, 0, 0, 0);
    } else {
      x[q] = make_float4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < A.k) comp(x[q], j) = xr[c + j];
    }
  }
  const float xb = xr[A.k];
  const int ref = reinterpret_cast<const int*>(xr)[A.k + 1];
  const float wu = __ldg(A.wdu + row);
  const float wi = __ldg(A.wdi + row);

  Sums<NC> a;
  clear(a);
  sum_entries<NC, VEC>(a, A, p0, p1, first, g, gmask, lane0, 0);
  if (slot < 0) {
    finish_row<NC, VEC>(a, A, row, x, xb, ref, wu, wi, g, gmask);
    return;
  }

  // a piece of a long run: leave the partial sums in the slot; the piece
  // that arrives last adds the run's partials in slot order and finishes
  const int PC = 64 * NC + 4;
  float* mine = A.part + (int64_t)slot * PC;
#pragma unroll
  for (int q = 0; q < NC; ++q) reinterpret_cast<float4*>(mine)[16 * q + g] = a.dw[q];
  if (g == 0) reinterpret_cast<float4*>(mine + 64 * NC)[0] = make_float4(a.db, a.cu, a.ci, 0.0f);
  const int2 span = __ldg(A.pieces + slot);
  if (span.x < 0 || span.y < 1 || span.x + span.y > A.n_slots || slot < span.x ||
      slot >= span.x + span.y)
    __trap();
  __threadfence();  // the partials are visible before the arrival counts
  __syncwarp(gmask);
  int arrived = 0;
  if (g == 0) arrived = atomicAdd(A.count + span.x, 1);
  arrived = __shfl_sync(gmask, arrived, lane0);
  if (arrived != span.y - 1) return;
  __threadfence();
  clear(a);
  const int s_end = span.x + span.y;
  for (int s0 = span.x; s0 < s_end; s0 += kPartialsAhead) {
    float4 v[kPartialsAhead][NC];
    float4 sc[kPartialsAhead];
#pragma unroll
    for (int u = 0; u < kPartialsAhead; ++u) {
      const float* pp = A.part + (int64_t)min(s0 + u, s_end - 1) * PC;
#pragma unroll
      for (int q = 0; q < NC; ++q) v[u][q] = __ldcg(reinterpret_cast<const float4*>(pp) + 16 * q + g);
      sc[u] = __ldcg(reinterpret_cast<const float4*>(pp + 64 * NC));
    }
#pragma unroll
    for (int u = 0; u < kPartialsAhead; ++u) {
      if (s0 + u >= s_end) break;
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        a.dw[q].x += v[u][q].x;
        a.dw[q].y += v[u][q].y;
        a.dw[q].z += v[u][q].z;
        a.dw[q].w += v[u][q].w;
      }
      a.db += sc[u].x;
      a.cu += sc[u].y;
      a.ci += sc[u].z;
    }
  }
  if (g == 0) A.count[span.x] = 0;  // as the next call expects it
  finish_row<NC, VEC>(a, A, row, x, xb, ref, wu, wi, g, gmask);
}

// ---- rows of more than 64 * kPassChunks factors: sweep_wide_kernel ----
// Its own helpers: the kernels above keep the code they had, whose machine
// code (and time) routing them through these would change.

// this lane's columns of the NC chunks from column c0 of the row at xr (0
// past k); plain loads: the wide kernel reads back what it wrote
template <int NC, bool VEC>
__device__ __forceinline__ void load_cols(float4 (&x)[NC], const float* xr, int c0, int k, int g) {
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int c = c0 + 64 * q + 4 * g;
    if (VEC) {
      x[q] = c < k ? *reinterpret_cast<const float4*>(xr + c) : make_float4(0, 0, 0, 0);
    } else {
      x[q] = make_float4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < k) comp(x[q], j) = xr[c + j];
    }
  }
}

template <int NC, bool VEC>
__device__ __forceinline__ void store_cols(float* xr, int c0, int k, const float4 (&nw)[NC], int g) {
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int c = c0 + 64 * q + 4 * g;
    if (VEC) {
      if (c < k) *reinterpret_cast<float4*>(xr + c) = nw[q];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < k) xr[c + j] = comp(nw[q], j);
    }
  }
}

// The last-visit math of the TPU kernel on the factor columns x that this
// lane holds of one touched row (ref: its lazy counter), before
// reg_method 2's scale onto the ball, which needs the whole row's norm.
template <int NC>
__device__ __forceinline__ void step_cols(float4 (&nw)[NC], const Sums<NC>& a, const SweepArgs& A,
                                          const float4 (&x)[NC], int ref, float wu, float wi) {
  const float cu = a.cu, ci = a.ci;
  const int m = A.reg_method;
  const float lr = A.scal[0];
  if (m >= 4) {
    const float el = (float)(A.stepi[0] - ref);
    const float lam = lr * (cu > 0.0f ? wu : wi);
    const float fac = expf(el * log1m(lam));
#pragma unroll
    for (int q = 0; q < NC; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xv = comp(x[q], j);
        comp(nw[q], j) = (m == 4 ? xv * fac : soft(xv, lam * el)) + comp(a.dw[q], j);
      }
    return;
  }
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    nw[q].x = x[q].x + a.dw[q].x;
    nw[q].y = x[q].y + a.dw[q].y;
    nw[q].z = x[q].z + a.dw[q].z;
    nw[q].w = x[q].w + a.dw[q].w;
  }
  if (m == 2) return;
  const float fac0 = expf(cu * log1m(lr * wu) + ci * log1m(lr * wi));
  const float thr1 = lr * (wu * cu + wi * ci);
  const float thr3 = lr * wu * cu;
  const float fac3 = expf(ci * log1m(lr * wi));
#pragma unroll
  for (int q = 0; q < NC; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float& v = comp(nw[q], j);
      if (m == 0) v *= fac0;
      else if (m == 1) v = soft(v, thr1);
      else v = soft(v, thr3) * fac3;
    }
}

// this lane's share of a row's squared norm (columns past k hold 0)
template <int NC>
__device__ __forceinline__ float sq_cols(const float4 (&nw)[NC]) {
  float sq = 0.0f;
#pragma unroll
  for (int q = 0; q < NC; ++q)
    sq += nw[q].x * nw[q].x + nw[q].y * nw[q].y + nw[q].z * nw[q].z + nw[q].w * nw[q].w;
  return sq;
}

// reg_method 2: the factor that puts the row (its lanes' shares of the
// squared norm summed over the group) onto the ball |w|^2 <= wd
__device__ __forceinline__ float ball_scale(float sq, float cu, float wu, float wi,
                                            unsigned gmask) {
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1) sq += __shfl_xor_sync(gmask, sq, o);
  const float wd_row = cu > 0.0f ? wu : wi;
  return sq > wd_row ? sqrtf(wd_row / fmaxf(sq, 1e-30f)) : 1.0f;
}

// the scale (1 but under reg_method 2) and the nonnegative clamps
template <int NC>
__device__ __forceinline__ void scale_clamp(float4 (&nw)[NC], float scale, const SweepArgs& A,
                                            float cu, float ci) {
#pragma unroll
  for (int q = 0; q < NC; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float& v = comp(nw[q], j);
      if (A.reg_method == 2) v *= scale;
      if (A.user_nonneg && cu > 0.0f) v = fmaxf(v, 0.0f);
      if (A.item_nonneg && ci > 0.0f) v = fmaxf(v, 0.0f);
    }
}

// the row's new bias, from its old one plus the entries' sum b
__device__ __forceinline__ float new_bias(const SweepArgs& A, float cu, float ci, float b) {
  const float lr = A.scal[0];
  float logb = ci * log1m(lr * A.scal[2]);
  if (A.with_user_bias) logb += cu * log1m(lr * A.scal[1]);
  return b * expf(logb);
}

// the bias and (lazy modes) the ref stamp, by the group's lane 0 after
// every lane of the group has read them
__device__ __forceinline__ void write_bias_ref(const SweepArgs& A, float* xr, float nb) {
  xr[A.k] = nb;
  if (A.reg_method >= 4) reinterpret_cast<int*>(xr)[A.k + 1] = A.stepi[0];
}

// A run's record: plan positions [p0, p1), table row, piece slot (-1: the
// whole run), and this lane's first plan source src[p0 + g].
struct Run {
  int p0, p1, slot, first;
  int64_t row;
};

// the record of run t, checked; false for an empty run (padding)
__device__ __forceinline__ bool load_run(Run& r, const SweepArgs& A, int t, int g) {
  const int4 rec = __ldg(A.runs + t);
  r.p0 = rec.x;
  r.p1 = rec.y;
  r.slot = rec.w;
  if (r.p0 >= r.p1) return false;  // an empty run pads the batch's run list
  r.row = rec.z;
  if (r.p0 < 0 || r.p1 > A.n_plan || r.row < 0 || r.row >= A.n_pad || r.slot < -1 ||
      r.slot >= A.n_slots)
    __trap();
  const int E = A.B * A.Su + A.B * A.Si;
  r.first = g < r.p1 - r.p0 ? __ldg(A.src + r.p0 + g) : E;
  return true;
}

// a piece's partial sums of the chunks [q0, q0 + NC) into its slot's
// floats pp (chunks from nc on are past the row)
template <int NC>
__device__ __forceinline__ void put_partials(float* pp, const Sums<NC>& a, int q0, int nc, int g) {
#pragma unroll
  for (int q = 0; q < NC; ++q)
    if (q0 + q < nc) reinterpret_cast<float4*>(pp)[16 * (q0 + q) + g] = a.dw[q];
}

// A piece's arrival, its partials in its slot: true for the piece that
// arrives last, which then finishes the run (span: the run's slots).
__device__ __forceinline__ bool last_piece(const SweepArgs& A, int slot, int2& span, int g,
                                           unsigned gmask, int lane0) {
  span = __ldg(A.pieces + slot);
  if (span.x < 0 || span.y < 1 || span.x + span.y > A.n_slots || slot < span.x ||
      slot >= span.x + span.y)
    __trap();
  __threadfence();  // the partials are visible before the arrival counts
  __syncwarp(gmask);
  int arrived = 0;
  if (g == 0) arrived = atomicAdd(A.count + span.x, 1);
  arrived = __shfl_sync(gmask, arrived, lane0);
  if (arrived != span.y - 1) return false;
  __threadfence();
  return true;
}

// the run's sums over the chunks [q0, q0 + NC), its pieces' partials
// (slots of PC floats, the scalars last) added in slot order
template <int NC>
__device__ __forceinline__ void add_partials(Sums<NC>& a, const SweepArgs& A, int2 span, int PC,
                                             int q0, int nc, int g) {
  clear(a);
  const int s_end = span.x + span.y;
  for (int s0 = span.x; s0 < s_end; s0 += kWidePartialsAhead) {
    float4 v[kWidePartialsAhead][NC];
    float4 sc[kWidePartialsAhead];
#pragma unroll
    for (int u = 0; u < kWidePartialsAhead; ++u) {
      const float* pp = A.part + (int64_t)min(s0 + u, s_end - 1) * PC;
#pragma unroll
      for (int q = 0; q < NC; ++q)
        v[u][q] = q0 + q < nc ? __ldcg(reinterpret_cast<const float4*>(pp) + 16 * (q0 + q) + g)
                              : make_float4(0, 0, 0, 0);
      sc[u] = __ldcg(reinterpret_cast<const float4*>(pp + PC - 4));
    }
#pragma unroll
    for (int u = 0; u < kWidePartialsAhead; ++u) {
      if (s0 + u >= s_end) break;
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        a.dw[q].x += v[u][q].x;
        a.dw[q].y += v[u][q].y;
        a.dw[q].z += v[u][q].z;
        a.dw[q].w += v[u][q].w;
      }
      a.db += sc[u].x;
      a.cu += sc[u].y;
      a.ci += sc[u].z;
    }
  }
}

// k > 64 * kPassChunks: the row in passes of kPassChunks chunks, each
// summed (a piece: all its passes into its slot first), stepped and
// written before the next; reg_method 2 writes the unscaled row, then
// scales the lane's own columns once the group has the whole norm.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks) sweep_wide_kernel(const SweepArgs A) {
  constexpr int NC = kPassChunks;
  const int lane = threadIdx.x & 31;
  const int g = lane & (kGroup - 1);
  const int lane0 = lane & kGroup;
  const unsigned gmask = 0xffffu << lane0;
  const int t = blockIdx.x * kGroupsPerBlock + (threadIdx.x / kGroup);
  if (t >= A.n_runs) return;

  Run r;
  if (!load_run(r, A, t, g)) return;
  float* xr = A.w + r.row * A.W;
  const float xb = xr[A.k];
  const int ref = reinterpret_cast<const int*>(xr)[A.k + 1];
  const float wu = __ldg(A.wdu + r.row);
  const float wi = __ldg(A.wdi + r.row);
  const int nc = (A.k + 63) / 64;
  const int PC = 64 * nc + 4;

  Sums<NC> a;
  int2 span = make_int2(0, 0);
  if (r.slot >= 0) {
    float* pp = A.part + (int64_t)r.slot * PC;
    for (int q0 = 0; q0 < nc; q0 += NC) {
      clear(a);
      sum_entries<NC, VEC>(a, A, r.p0, r.p1, r.first, g, gmask, lane0, 64 * q0);
      put_partials<NC>(pp, a, q0, nc, g);
    }
    if (g == 0) reinterpret_cast<float4*>(pp + 64 * nc)[0] = make_float4(a.db, a.cu, a.ci, 0.0f);
    if (!last_piece(A, r.slot, span, g, gmask, lane0)) return;
    if (g == 0) A.count[span.x] = 0;  // every piece has arrived; as the next call expects it
  }
  const bool ball = A.reg_method == 2;
  float sq = 0.0f;
  for (int q0 = 0; q0 < nc; q0 += NC) {
    if (r.slot < 0) {
      clear(a);
      sum_entries<NC, VEC>(a, A, r.p0, r.p1, r.first, g, gmask, lane0, 64 * q0);
    } else {
      add_partials<NC>(a, A, span, PC, q0, nc, g);
    }
    // the counts are the same in every pass: an untouched row is left at
    // the first, before anything is written
    if (!((a.cu + a.ci) > 0.0f)) return;
    float4 x[NC], nw[NC];
    load_cols<NC, VEC>(x, xr, 64 * q0, A.k, g);
    step_cols<NC>(nw, a, A, x, ref, wu, wi);
    if (ball) sq += sq_cols<NC>(nw);
    else scale_clamp<NC>(nw, 1.0f, A, a.cu, a.ci);
    store_cols<NC, VEC>(xr, 64 * q0, A.k, nw, g);
  }
  if (ball) {
    const float scale = ball_scale(sq, a.cu, wu, wi, gmask);
    for (int q0 = 0; q0 < nc; q0 += NC) {
      float4 nw[NC];
      load_cols<NC, VEC>(nw, xr, 64 * q0, A.k, g);
      scale_clamp<NC>(nw, scale, A, a.cu, a.ci);
      store_cols<NC, VEC>(xr, 64 * q0, A.k, nw, g);
    }
  }
  const float nb = new_bias(A, a.cu, a.ci, xb + a.db);
  __syncwarp(gmask);  // every lane of the group has read the bias and ref
  if (g == 0) write_bias_ref(A, xr, nb);
}

template <int NC>
cudaError_t launch(const SweepArgs& A, bool vec, int blocks, cudaStream_t stream) {
  if (vec) sweep_apply_kernel<NC, true><<<blocks, kThreads, 0, stream>>>(A);
  else sweep_apply_kernel<NC, false><<<blocks, kThreads, 0, stream>>>(A);
  return cudaGetLastError();
}

cudaError_t launch_wide(const SweepArgs& A, bool vec, int blocks, cudaStream_t stream) {
  if (vec) sweep_wide_kernel<true><<<blocks, kThreads, 0, stream>>>(A);
  else sweep_wide_kernel<false><<<blocks, kThreads, 0, stream>>>(A);
  return cudaGetLastError();
}

}  // namespace

// ptrs: w, runs, pieces, src, p_u, p_i, coef_u, coef_i, wdu, wdi, scal,
// stepi, part, count (the order of SweepArgs); ints: n_runs, n_slots,
// n_plan, B, Su, Si, n_pad, W, k, reg_method, user_nonneg, item_nonneg,
// with_user_bias, vec (1: p_u / p_i rows are 16-byte aligned float4 rows).
extern "C" int sweep_apply(void** ptrs, const int* ints, void* stream) {
  SweepArgs A;
  A.w = static_cast<float*>(ptrs[0]);
  A.runs = static_cast<const int4*>(ptrs[1]);
  A.pieces = static_cast<const int2*>(ptrs[2]);
  A.src = static_cast<const int*>(ptrs[3]);
  A.p_u = static_cast<const float*>(ptrs[4]);
  A.p_i = static_cast<const float*>(ptrs[5]);
  A.coef_u = static_cast<const float*>(ptrs[6]);
  A.coef_i = static_cast<const float*>(ptrs[7]);
  A.wdu = static_cast<const float*>(ptrs[8]);
  A.wdi = static_cast<const float*>(ptrs[9]);
  A.scal = static_cast<const float*>(ptrs[10]);
  A.stepi = static_cast<const int*>(ptrs[11]);
  A.part = static_cast<float*>(ptrs[12]);
  A.count = static_cast<int*>(ptrs[13]);
  A.n_runs = ints[0];
  A.n_slots = ints[1];
  A.n_plan = ints[2];
  A.B = ints[3];
  A.Su = ints[4];
  A.Si = ints[5];
  A.n_pad = ints[6];
  A.W = ints[7];
  A.k = ints[8];
  A.reg_method = ints[9];
  A.user_nonneg = ints[10];
  A.item_nonneg = ints[11];
  A.with_user_bias = ints[12];
  const bool vec = ints[13] != 0;
  const int blocks = (A.n_runs + kGroupsPerBlock - 1) / kGroupsPerBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (A.k + 63) / 64;
  cudaError_t err = cudaErrorInvalidValue;
  if (nc == 1) err = launch<1>(A, vec, blocks, s);
  else if (nc == 2) err = launch<2>(A, vec, blocks, s);
  else if (nc == 3) err = launch<3>(A, vec, blocks, s);
  else if (nc == 4) err = launch<4>(A, vec, blocks, s);
  else if (nc > 4) err = launch_wide(A, vec, blocks, s);
  return (int)err;
}
