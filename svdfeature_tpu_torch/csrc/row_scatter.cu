// Indexed row copies of the big-table route on Hopper: the unique-row
// writer (K5) and its mirror, the row reader (K6).
//
// Replace the TPU kernels svdfeature_tpu/ops/pallas_scatter.py
// ::_writer_kernel (row_writer, w[idx[j]] = vals[j] in place) and
// ::_reader_kernel (row_reader, out[j] = w[idx[j]]).  The TPU issues one
// DMA descriptor per row from its scalar core, 16 in flight, and splits a
// call into slices of at most 131,072 rows because its index operand
// lives in a 1 MiB SMEM; none of that exists here, so one launch covers
// the whole call.
//
// What bounds them on the card: bytes.  Each copies E rows of W floats
// and reads E indices, no arithmetic: E * (2 * 4W + 4) bytes.  The design
// keeps that traffic in full 16-byte transactions and leaves the address
// arithmetic to the hardware:
//   * a 2-D block: threadIdx.x is the 16-byte column of a row (W / 4 of
//     them; one float per thread when W % 4 != 0 or a pointer is not
//     16-byte aligned), threadIdx.y the row, so no thread divides;
//   * the block's row indices are loaded once, coalesced, into shared
//     memory and checked there (an index outside the table traps);
//   * on large calls a thread moves four rows, all four loads started
//     before the first store, to keep more bytes in flight;
//   * the contiguous side (vals read, out written) is touched once, so it
//     goes with the streaming hint (ld/st .cs); so do the writer's table
//     stores: the 557 MB table does not fit the 50 MB L2 and the kernel
//     never re-reads a row it wrote.
//
// The writer's targets are unique except the dummy row n-1: several
// positions may write it, but all of them write zeros
// (ops/big_embed.apply_entries).  At E = 2^21 about 419,000 positions do,
// 7 million 16-byte stores to one 272-byte row, which one L2 slice takes
// one after the other.  So a store whose target is the dummy row is a
// compare-then-store: the thread reads the 16 bytes there and stores only
// if the bits differ.  This is exact for every input the contract allows
// (all writers of the dummy row carry the same value V): a thread reads
// either the row's old content X or V; if X == V nobody needs to store,
// and if X != V the first thread to read (and any that still sees X)
// stores V, so the row ends as V either way.  The read may come from L1:
// a stale X only causes a redundant store of V.
//
// Plain C interface (ctypes, svdfeature_tpu_torch/ops/_build.py): each entry
// point launches on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDeepRows = 4;         // rows per thread on large calls
constexpr int kDeepCall = 1 << 16;   // calls of at least this many rows go deep

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}
__device__ __forceinline__ bool same_bits(const float4& a, const float4& b) {
  return same_bits(a.x, b.x) && same_bits(a.y, b.y) && same_bits(a.z, b.z) &&
         same_bits(a.w, b.w);
}

// The block's rows [row0, row0 + rows) of idx into shared memory, checked.
__device__ __forceinline__ void stage_rows(const int* __restrict__ idx, int64_t row0, int rows,
                                           int E, int n, int* s_row) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < rows; i += blockDim.x * blockDim.y) {
    const int64_t j = row0 + i;
    const int r = j < E ? idx[j] : 0;
    if (r < 0 || r >= n) __trap();
    s_row[i] = r;
  }
  __syncthreads();
}

template <typename V, int kRows>
__global__ void __launch_bounds__(kThreads) row_write_kernel(
    V* __restrict__ w, const int* __restrict__ idx, const V* __restrict__ vals, int E, int nv,
    int n) {
  __shared__ int s_row[kThreads * kRows];
  const int ry = blockDim.y;
  const int64_t row0 = (int64_t)blockIdx.x * (ry * kRows);
  stage_rows(idx, row0, ry * kRows, E, n, s_row);
  for (int c = threadIdx.x; c < nv; c += blockDim.x) {
    V v[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t j = row0 + i * ry + threadIdx.y;
      if (j < E) v[i] = __ldcs(vals + j * nv + c);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t j = row0 + i * ry + threadIdx.y;
      if (j >= E) continue;
      const int r = s_row[i * ry + threadIdx.y];
      V* dst = w + (int64_t)r * nv + c;
      // the dummy row: compare, then store (see the note at the top)
      if (r == n - 1 && same_bits(__ldca(dst), v[i])) continue;
      __stcs(dst, v[i]);
    }
  }
}

template <typename V, int kRows>
__global__ void __launch_bounds__(kThreads) row_read_kernel(
    const V* __restrict__ w, const int* __restrict__ idx, V* __restrict__ out, int E, int nv,
    int n) {
  __shared__ int s_row[kThreads * kRows];
  const int ry = blockDim.y;
  const int64_t row0 = (int64_t)blockIdx.x * (ry * kRows);
  stage_rows(idx, row0, ry * kRows, E, n, s_row);
  for (int c = threadIdx.x; c < nv; c += blockDim.x) {
    V v[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t j = row0 + i * ry + threadIdx.y;
      if (j < E) v[i] = __ldg(w + (int64_t)s_row[i * ry + threadIdx.y] * nv + c);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t j = row0 + i * ry + threadIdx.y;
      if (j < E) __stcs(out + j * nv + c, v[i]);
    }
  }
}

bool vec4(const void* a, const void* b, int W) {
  return W % 4 == 0 && ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 16 == 0);
}

// the block (columns, rows) and the grid of a call of E rows of nv columns
struct Shape {
  dim3 block;
  unsigned grid;
};

Shape shape_for(int E, int nv, int rows_per_thread) {
  const int bx = nv < kThreads ? nv : kThreads;
  const int by = kThreads / bx;
  const int64_t rows = (int64_t)by * rows_per_thread;
  return {dim3(bx, by), (unsigned)((E + rows - 1) / rows)};
}

template <typename V>
void launch_write(V* w, const int* idx, const V* vals, int E, int nv, int n, cudaStream_t s) {
  if (E >= kDeepCall) {
    const Shape sh = shape_for(E, nv, kDeepRows);
    row_write_kernel<V, kDeepRows><<<sh.grid, sh.block, 0, s>>>(w, idx, vals, E, nv, n);
  } else {
    const Shape sh = shape_for(E, nv, 1);
    row_write_kernel<V, 1><<<sh.grid, sh.block, 0, s>>>(w, idx, vals, E, nv, n);
  }
}

template <typename V>
void launch_read(const V* w, const int* idx, V* out, int E, int nv, int n, cudaStream_t s) {
  if (E >= kDeepCall) {
    const Shape sh = shape_for(E, nv, kDeepRows);
    row_read_kernel<V, kDeepRows><<<sh.grid, sh.block, 0, s>>>(w, idx, out, E, nv, n);
  } else {
    const Shape sh = shape_for(E, nv, 1);
    row_read_kernel<V, 1><<<sh.grid, sh.block, 0, s>>>(w, idx, out, E, nv, n);
  }
}

}  // namespace

// w[idx[j]] = vals[j] for j < E; w is [n, W], vals [E, W], both f32.
extern "C" int row_write(float* w, const int* idx, const float* vals, int E, int W, int n,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4(w, vals, W)) {
    launch_write(reinterpret_cast<float4*>(w), idx, reinterpret_cast<const float4*>(vals), E,
                 W / 4, n, s);
  } else {
    launch_write(w, idx, vals, E, W, n, s);
  }
  return (int)cudaGetLastError();
}

// out[j] = w[idx[j]] for j < E; w is [n, W], out [E, W], both f32.
extern "C" int row_read(const float* w, const int* idx, float* out, int E, int W, int n,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4(w, out, W)) {
    launch_read(reinterpret_cast<const float4*>(w), idx, reinterpret_cast<float4*>(out), E, W / 4,
                n, s);
  } else {
    launch_read(w, idx, out, E, W, n, s);
  }
  return (int)cudaGetLastError();
}

// An entry point that launches nothing: the cost of a ctypes call with
// row_write's arguments, for scripts/kernel_split.py.
extern "C" int row_noop(float*, const int*, const float*, int, int, int, void*) { return 0; }
