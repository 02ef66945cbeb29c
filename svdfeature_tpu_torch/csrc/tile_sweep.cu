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
//   * a wider row (k > 256) goes to a kernel of its own, sweep_wide_kernel, so
//     the k <= 256 kernels keep their code: a warp a run, each lane summing
//     float4 columns 4g + 128q of the whole row up to 512 factors in registers
//     (3 float4 up to 384 factors, 4 above; 72-128 registers a thread by form,
//     no spills).  The row (cp.async into shared memory), bias, ref bits and
//     decay rates are loaded with the run's record while the run's plan sources
//     and coefficients are staged in shared memory; the entries' p_u / p_i rows
//     then come in through a ring of 4 cp.async stages a warp (16-byte copies,
//     or coalesced 4-byte ones where k % 4 != 0 or p_u / p_i are not 16-byte
//     aligned; the adds read float4 from shared memory either way), so 3 entries
//     are in flight beside the one being added.  Rows of more than 512 factors
//     take passes of 512 columns, each walking the staged plan again (the port's
//     plans cut their runs into pieces that the stage holds).  A piece writes
//     its partials for the whole width once; the last piece brings every piece's
//     partials in through the same ring, and the plans list the pieces first, so
//     that these chains start with the launch.  reg_method 2 over more than one
//     pass writes the unscaled row, sums its squares, and a last walk over the
//     lane's own columns scales them.  Bound: bytes, as above; a long run's
//     pieces and its last piece's adds are chains of ring waits, which bound a
//     skewed batch.
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


// ---- rows of more than 256 factors: sweep_wide_kernel ----
// Its own constants and helpers: the kernels above keep the code they had,
// whose machine code (and time) routing them through these would change.

constexpr int kWideWarps = 4;  // runs a block, one warp each
constexpr int kWideThreads = 32 * kWideWarps;
// blocks an SM the registers must allow (the rows in flight and the table
// row sit in shared memory, not in registers), by the float4 columns NV a
// lane holds (3: k <= 384, 4: wider) and the copies' form: the most with
// which ptxas spills nothing on sm_90a (NV=3: 7, i.e. 72 registers, for
// 16-byte copies and 5, i.e. 96, for 4-byte ones; NV=4: 4, 107 and 128
// registers).  ptxas is not monotone here: a bound between two that fit
// can spill.
template <int NV, bool VEC>
constexpr int kWideMinBlocks = NV == 3 ? (VEC ? 7 : 5) : 4;
constexpr int kWideNV = 4;                  // float4 columns a lane holds, at most
constexpr int kWideSweep = 128 * kWideNV;   // columns one sweep holds
constexpr int kWideStages = 4;              // rows in flight a warp (cp.async ring)
// plan entries a warp stages at once (tile_sweep.SWEEP_WIDE_PLAN: the
// port's plans cut rows of more than kWideSweep factors into pieces of at
// most this many entries, so that each pass walks the staged plan again)
constexpr int kWidePlan = 64;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, around L1 (each source row is read once)
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// 4 bytes global -> shared, of which the first ``bytes`` read (the rest 0)
__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A warp's shared memory: a ring of kWideStages rows of ss floats (a
// sweep's columns, then 4 for a piece's scalars), the table row's sweep
// (xs), and the staged plan: each entry's factor row (r >= 0: p_i row r of
// a user entry; r <= -2: p_u row -2 - r of an item entry; -1: padding)
// and its coefficient.
// (Offsets in floats from the start of the block's dynamic shared memory,
// so that every access stays a 32-bit shared one.)
struct Wide {
  int ring, xs, pl_row, pl_coef, ss, g;
};

// the block's dynamic shared memory (kWideWarps warps' worth)
__device__ __forceinline__ float* wsm() {
  extern __shared__ float4 wide_smem[];
  return reinterpret_cast<float*>(wide_smem);
}

// the floats of one warp's shared memory at k factors
__host__ __device__ __forceinline__ int wide_ss(int k) {
  return 128 * (k < kWideSweep ? (k + 127) / 128 : kWideNV) + 4;
}
__host__ __device__ __forceinline__ int wide_warp_floats(int k) {
  return (kWideStages + 1) * wide_ss(k) + 2 * kWidePlan;
}

__device__ __forceinline__ Wide wide_warp(int warp, int k, int g) {
  const int ss = wide_ss(k);
  const int mine = warp * wide_warp_floats(k);
  const int plan = mine + (kWideStages + 1) * ss;
  return Wide{mine, mine + kWideStages * ss, plan, plan + kWidePlan, ss, g};
}

// starts the copy of this lane's columns c = 4g + 128q < kp of the table
// row at xr (16 bytes each: the row is 16-byte aligned) into xs
template <int NV>
__device__ __forceinline__ void stage_row(const Wide& W, const float* xr, int kp) {
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    const int c = 4 * W.g + 128 * q;
    if (c < kp) cp16(wsm() + W.xs + c, xr + c);
  }
  cp_commit();
}

// this lane's staged columns of the row (0 past kp), once they have landed
template <int NV>
__device__ __forceinline__ void row_cols(float4 (&x)[NV], const Wide& W, int kp) {
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    const int c = 4 * W.g + 128 * q;
    x[q] = c < kp ? *reinterpret_cast<const float4*>(wsm() + W.xs + c) : make_float4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j >= kp) comp(x[q], j) = 0.0f;
  }
}

// Stages the plan positions [p, p + m), m <= kWidePlan: their sources
// (4-byte copies), with the first kp columns of the table row at xr behind
// them where xr is given (the sources' wait leaves the row in flight; the
// ring's first wait lands it), then each source's factor row, and starts
// the copies of their coefficients, which land before the first row that
// the ring brings in after them (their group is older).
template <int NV>
__device__ __forceinline__ void stage_plan(const SweepArgs& A, const Wide& W, int p, int m,
                                           const float* xr, int kp) {
  int* pl_row = reinterpret_cast<int*>(wsm()) + W.pl_row;
  for (int j = W.g; j < m; j += 32) cp4(pl_row + j, A.src + p + j, 4);
  cp_commit();
  if (xr) {
    stage_row<NV>(W, xr, kp);
    cp_wait<1>();
  } else {
    cp_wait<0>();
  }
  __syncwarp();
  const int BSu = A.B * A.Su;
  const int E = BSu + A.B * A.Si;
  for (int j = W.g; j < m; j += 32) {
    const int s = pl_row[j];
    if (s < 0 || s > E) __trap();
    const bool user = s < BSu;
    const float* c = user ? A.coef_u + s : A.coef_i + (s - BSu);
    cp4(wsm() + W.pl_coef + j, s == E ? A.coef_u : c, s == E ? 0 : 4);  // padding: 0
    pl_row[j] = s == E ? -1 : (user ? s / A.Su : -2 - (s - BSu) / A.Si);
  }
  cp_commit();
  __syncwarp();  // the rows, for every lane's copies
}

// Rows [0, n) through the warp's ring, kWideStages - 1 ahead of the one
// added: issue(j, stage) starts row j's copies, add(j, stage) adds it once
// it has arrived, in order.
template <class Issue, class Add>
__device__ __forceinline__ void ring_walk(const Wide& W, int n, Issue issue, Add add) {
#pragma unroll
  for (int j = 0; j < kWideStages - 1; ++j) {
    if (j < n) issue(j, wsm() + W.ring + j * W.ss);
    cp_commit();
  }
  for (int j = 0; j < n; ++j) {
    const int next = j + kWideStages - 1;
    if (next < n) issue(next, wsm() + W.ring + (next % kWideStages) * W.ss);
    cp_commit();
    cp_wait<kWideStages - 1>();  // row j's group has landed
    __syncwarp();                // for every lane of the warp
    add(j, wsm() + W.ring + (j % kWideStages) * W.ss);
    __syncwarp();                // its stage is free again
  }
}

// The staged entries [0, m) over the sweep's columns [0, kp) of row
// pointer offset pc0; counts and bias sums too when ``counts``.
template <int NV, bool VEC>
__device__ __forceinline__ void walk_entries(Sums<NV>& a, const SweepArgs& A, const Wide& W,
                                             int m, int pc0, int kp, bool counts) {
  const int g = W.g;
  const int kp4 = (kp + 3) & ~3;
  auto issue = [&](int j, float* st) {
    const int r = reinterpret_cast<const int*>(wsm())[W.pl_row + j];
    if (r == -1) return;
    const float* row = (r >= 0 ? A.p_i + (int64_t)r * A.k : A.p_u + (int64_t)(-2 - r) * A.k) + pc0;
    if (VEC) {
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const int c = 4 * g + 128 * q;
        if (c < kp) cp16(st + c, row + c);
      }
    } else {
      // coalesced 4-byte copies (lane g: columns g + 32 jj); the columns
      // past kp of the last float4 read as 0
#pragma unroll
      for (int jj = 0; jj < 4 * NV; ++jj) {
        const int c = g + 32 * jj;
        if (c < kp4) cp4(st + c, c < kp ? row + c : row, c < kp ? 4 : 0);
      }
    }
  };
  auto add = [&](int j, const float* st) {
    const int r = reinterpret_cast<const int*>(wsm())[W.pl_row + j];
    if (r == -1) return;  // padding adds nothing, not even a count
    const float c = wsm()[W.pl_coef + j];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int col = 4 * g + 128 * q;
      if (col < kp) {
        const float4 v = *reinterpret_cast<const float4*>(st + col);
        a.dw[q].x += c * v.x;
        a.dw[q].y += c * v.y;
        a.dw[q].z += c * v.z;
        a.dw[q].w += c * v.w;
      }
    }
    if (counts) {
      if (r >= 0) {
        a.cu += 1.0f;
        a.db += A.with_user_bias ? c : 0.0f;
      } else {
        a.ci += 1.0f;
        a.db += c;
      }
    }
  };
  ring_walk(W, m, issue, add);
}

// A run's pieces' partials (slots span.x.., PC floats each, the scalars
// last) over the sweep's columns [pc0, pc0 + kp), added in slot order;
// their scalars too when ``counts``.
template <int NV>
__device__ __forceinline__ void walk_partials(Sums<NV>& a, const SweepArgs& A, const Wide& W,
                                              int2 span, int PC, int pc0, int kp, bool counts) {
  const int g = W.g;
  auto issue = [&](int j, float* st) {
    const float* pp = A.part + (int64_t)(span.x + j) * PC;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int c = 4 * g + 128 * q;
      if (c < kp) cp16(st + c, pp + pc0 + c);
    }
    if (counts && g == 0) cp16(st + W.ss - 4, pp + PC - 4);
  };
  auto add = [&](int, const float* st) {
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int col = 4 * g + 128 * q;
      if (col < kp) {
        const float4 v = *reinterpret_cast<const float4*>(st + col);
        a.dw[q].x += v.x;
        a.dw[q].y += v.y;
        a.dw[q].z += v.z;
        a.dw[q].w += v.w;
      }
    }
    if (counts) {
      const float4 sc = *reinterpret_cast<const float4*>(st + W.ss - 4);
      a.db += sc.x;
      a.cu += sc.y;
      a.ci += sc.z;
    }
  };
  ring_walk(W, span.y, issue, add);
}

// this lane's float4 columns c = 4g + 128q < kp of the row at xr (0 past
// kp); plain loads: the ball's last walk reads back what the lane wrote
template <int NV>
__device__ __forceinline__ void load_cols(float4 (&x)[NV], const float* xr, int kp, int g) {
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    const int c = 4 * g + 128 * q;
    if (c + 4 <= kp) {
      x[q] = *reinterpret_cast<const float4*>(xr + c);
    } else {
      x[q] = make_float4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < kp) comp(x[q], j) = xr[c + j];
    }
  }
}

template <int NV>
__device__ __forceinline__ void store_cols(float* xr, int kp, const float4 (&nw)[NV], int g) {
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    const int c = 4 * g + 128 * q;
    if (c + 4 <= kp) {
      *reinterpret_cast<float4*>(xr + c) = nw[q];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < kp) xr[c + j] = comp(nw[q], j);
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
// squared norm summed over the warp) onto the ball |w|^2 <= wd
__device__ __forceinline__ float ball_scale(float sq, float cu, float wu, float wi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
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

// k > 256: a warp a run (or piece), lane g holding the float4 columns
// 4g + 128q of a sweep of up to 512; rows wider than that in passes of 512
// columns.  The run's record, then its row's first sweep, bias, ref and
// decay rates with the staging of its plan; the entries' factor rows
// through the warp's ring of cp.async stages, added in plan order.  A
// piece writes its partials for the whole width once; the last to arrive
// adds every piece's partials in slot order through the same ring.
// reg_method 2 over more than one pass writes the unscaled row, then
// scales the lane's own columns once the warp has the whole norm.
template <int NV, bool VEC>
__global__ void __launch_bounds__(kWideThreads, (kWideMinBlocks<NV, VEC>)) sweep_wide_kernel(const SweepArgs A) {
  const int g = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x * kWideWarps + warp;
  if (t >= A.n_runs) return;
  const int4 rec = __ldg(A.runs + t);
  const int p0 = rec.x, p1 = rec.y, slot = rec.w;
  if (p0 >= p1) return;  // an empty run pads the batch's run list
  const int64_t row = rec.z;
  if (p0 < 0 || p1 > A.n_plan || row < 0 || row >= A.n_pad || slot < -1 || slot >= A.n_slots)
    __trap();
  const int k = A.k;
  const Wide W = wide_warp(warp, k, g);
  float* xr = A.w + row * A.W;
  const float xb = xr[k];
  const int ref = reinterpret_cast<const int*>(xr)[k + 1];
  const float wu = __ldg(A.wdu + row);
  const float wi = __ldg(A.wdi + row);
  const int n = p1 - p0;
  const int npass = (k + kWideSweep - 1) / kWideSweep;
  const int PC = 64 * ((k + 63) / 64) + 4;
  Sums<NV> a;
  clear(a);

  // the entries' sums of one pass (its columns from pc0), the plan staged
  // again only where it did not fit the stage (a piece of a plan made
  // without the row's k)
  auto sum_pass = [&](int pc0, int kp) {
#pragma unroll
    for (int q = 0; q < NV; ++q) a.dw[q] = make_float4(0, 0, 0, 0);
    for (int b = 0; b < n; b += kWidePlan) {
      const int m = min(kWidePlan, n - b);
      if (pc0 == 0 || n > kWidePlan)
        stage_plan<NV>(A, W, p0 + b, m, pc0 == 0 && b == 0 ? xr : nullptr, kp);
      walk_entries<NV, VEC>(a, A, W, m, pc0, kp, pc0 == 0);
    }
  };

  int2 span = make_int2(0, 0);
  if (slot >= 0) {
    // a piece of a long run: leave the partial sums in the slot; the piece
    // that arrives last adds the run's partials in slot order and finishes
    float* pp = A.part + (int64_t)slot * PC;
    for (int pc0 = 0; pc0 < k; pc0 += kWideSweep) {
      const int kp = min(k - pc0, kWideSweep);
      sum_pass(pc0, kp);
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const int c = 4 * g + 128 * q;
        if (c < kp) *reinterpret_cast<float4*>(pp + pc0 + c) = a.dw[q];
      }
    }
    if (g == 0) *reinterpret_cast<float4*>(pp + PC - 4) = make_float4(a.db, a.cu, a.ci, 0.0f);
    span = __ldg(A.pieces + slot);
    if (span.x < 0 || span.y < 1 || span.x + span.y > A.n_slots || slot < span.x ||
        slot >= span.x + span.y)
      __trap();
    __threadfence();  // the partials are visible before the arrival counts
    __syncwarp();
    int arrived = 0;
    if (g == 0) arrived = atomicAdd(A.count + span.x, 1);
    arrived = __shfl_sync(0xffffffffu, arrived, 0);
    if (arrived != span.y - 1) return;
    __threadfence();
    if (g == 0) A.count[span.x] = 0;  // every piece has arrived; as the next call expects it
  }

  const bool ball = A.reg_method == 2;
  float sq = 0.0f;
  for (int pc0 = 0; pc0 < k; pc0 += kWideSweep) {
    const int kp = min(k - pc0, kWideSweep);
    if (pc0 > 0) stage_row<NV>(W, xr + pc0, kp);  // lands before the pass's first row
    if (slot < 0) {
      sum_pass(pc0, kp);
    } else {
      if (pc0 == 0) clear(a);
#pragma unroll
      for (int q = 0; q < NV; ++q) a.dw[q] = make_float4(0, 0, 0, 0);
      walk_partials<NV>(a, A, W, span, PC, pc0, kp, pc0 == 0);
    }
    // the counts come with the first pass: an untouched row is left there,
    // before anything is written
    if (!((a.cu + a.ci) > 0.0f)) return;
    float4 x[NV], nw[NV];
    row_cols<NV>(x, W, kp);
    step_cols<NV>(nw, a, A, x, ref, wu, wi);
    if (ball && npass > 1) {
      sq += sq_cols<NV>(nw);  // the unscaled row now, its scale below
    } else {
      scale_clamp<NV>(nw, ball ? ball_scale(sq_cols<NV>(nw), a.cu, wu, wi) : 1.0f, A,
                           a.cu, a.ci);
    }
    store_cols<NV>(xr + pc0, kp, nw, g);
  }
  if (ball && npass > 1) {
    const float scale = ball_scale(sq, a.cu, wu, wi);
    for (int pc0 = 0; pc0 < k; pc0 += kWideSweep) {
      const int kp = min(k - pc0, kWideSweep);
      float4 nw[NV];
      load_cols<NV>(nw, xr + pc0, kp, g);
      scale_clamp<NV>(nw, scale, A, a.cu, a.ci);
      store_cols<NV>(xr + pc0, kp, nw, g);
    }
  }
  const float nb = new_bias(A, a.cu, a.ci, xb + a.db);
  __syncwarp();  // every lane has read the bias and ref
  if (g == 0) {
    xr[k] = nb;
    if (A.reg_method >= 4) reinterpret_cast<int*>(xr)[k + 1] = A.stepi[0];
  }
}

template <int NC>
cudaError_t launch(const SweepArgs& A, bool vec, int blocks, cudaStream_t stream) {
  if (vec) sweep_apply_kernel<NC, true><<<blocks, kThreads, 0, stream>>>(A);
  else sweep_apply_kernel<NC, false><<<blocks, kThreads, 0, stream>>>(A);
  return cudaGetLastError();
}

template <int NV, bool VEC>
cudaError_t launch_wide(const SweepArgs& A, cudaStream_t stream) {
  const int blocks = (A.n_runs + kWideWarps - 1) / kWideWarps;
  const int bytes = sizeof(float) * kWideWarps * wide_warp_floats(A.k);
  if (bytes > 48 * 1024) {  // above what a launch gets without opting in
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_wide_kernel<NV, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  sweep_wide_kernel<NV, VEC><<<blocks, kWideThreads, bytes, stream>>>(A);
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
  else if (nc <= 6) err = vec ? launch_wide<3, true>(A, s) : launch_wide<3, false>(A, s);
  else err = vec ? launch_wide<4, true>(A, s) : launch_wide<4, false>(A, s);
  return (int)err;
}
