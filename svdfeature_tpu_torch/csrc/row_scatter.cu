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
// keeps that traffic in full 16-byte transactions: a group of W / 4
// consecutive threads moves one row as float4s (W % 4 == 0 and 16-byte
// aligned rows; any other width takes the same mapping with one float per
// thread), so a warp touches a few contiguous rows on each side, and every
// offset is 64-bit (2M rows x 68 floats is 139M floats).
//
// The writer's targets are unique except the dummy row: several positions
// may write it, but all of them write zeros (ops/big_embed.apply_entries),
// so those concurrent identical writes are benign and need no ordering.
// An index outside the table is a device fault (trap), never a stray write.
//
// Plain C interface (ctypes, svdfeature_tpu_torch/ops/_build.py): each entry
// point launches on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename V>
__global__ void __launch_bounds__(kThreads) row_write_kernel(
    V* __restrict__ w, const int* __restrict__ idx, const V* __restrict__ vals,
    int64_t total, int nv, int64_t n) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int64_t j = t / nv;
  const int64_t c = t - j * nv;
  const int64_t r = idx[j];
  if (r < 0 || r >= n) __trap();
  w[r * nv + c] = vals[t];
}

template <typename V>
__global__ void __launch_bounds__(kThreads) row_read_kernel(
    const V* __restrict__ w, const int* __restrict__ idx, V* __restrict__ out,
    int64_t total, int nv, int64_t n) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int64_t j = t / nv;
  const int64_t c = t - j * nv;
  const int64_t r = idx[j];
  if (r < 0 || r >= n) __trap();
  out[t] = w[r * nv + c];
}

bool vec4(const void* a, const void* b, int W) {
  return W % 4 == 0 && ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 16 == 0);
}

unsigned blocks_for(int64_t total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

}  // namespace

// w[idx[j]] = vals[j] for j < E; w is [n, W], vals [E, W], both f32.
extern "C" int row_write(float* w, const int* idx, const float* vals, int E, int W, int n,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4(w, vals, W)) {
    const int64_t total = (int64_t)E * (W / 4);
    row_write_kernel<float4><<<blocks_for(total), kThreads, 0, s>>>(
        reinterpret_cast<float4*>(w), idx, reinterpret_cast<const float4*>(vals), total,
        W / 4, n);
  } else {
    const int64_t total = (int64_t)E * W;
    row_write_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(w, idx, vals, total, W, n);
  }
  return (int)cudaGetLastError();
}

// out[j] = w[idx[j]] for j < E; w is [n, W], out [E, W], both f32.
extern "C" int row_read(const float* w, const int* idx, float* out, int E, int W, int n,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4(w, out, W)) {
    const int64_t total = (int64_t)E * (W / 4);
    row_read_kernel<float4><<<blocks_for(total), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(w), idx, reinterpret_cast<float4*>(out), total, W / 4,
        n);
  } else {
    const int64_t total = (int64_t)E * W;
    row_read_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(w, idx, out, total, W, n);
  }
  return (int)cudaGetLastError();
}
