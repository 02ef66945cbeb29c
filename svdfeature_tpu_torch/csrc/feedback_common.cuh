// Device code shared by the persistent user-group kernels, K2
// (fused_svdpp.cu, svdpp_rounds) and K3 (fused_imfb.cu, imfb_rounds): the
// pool flush of a chunk, the aggregate gather of one segment (a user for
// K2, a local feedback context for K3), and O @ delta on the tensor cores
// with the roles of the apply phase.  Each TU has its own copy (anonymous
// namespace); the bodies are inlined into the kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
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

}  // namespace
