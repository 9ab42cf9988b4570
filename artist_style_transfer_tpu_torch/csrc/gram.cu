// Batched normalized Gram matrix, G[n] = F[n]^T F[n] * scale, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel artist_style_transfer_tpu/ops/pallas/gram_kernel.py
// (gram_matrix_pallas). F[n] is the (HW, C) row-major view of an NHWC feature
// map (f32 or bf16), G is (C, C) f32.
//
// Design (simple and right first):
// - each block computes one 64x64 tile of G over one split of the HW axis;
//   256 threads, a 4x4 micro-tile each, f32 FMA on the CUDA cores (no TF32 and
//   no tensor cores: parity mode forbids TF32, so the kernel is bound by FP32
//   FMA throughput at the VGG tap shapes);
// - the HW axis is walked in chunks of 16 rows staged in shared memory; a row
//   of F is read along C, so neighbouring threads read neighbouring addresses;
// - split-K over HW fills the card when N * tiles is small (relu1_2 at N=1 is a
//   single 64x64 tile); each split writes its partial tile to a workspace, and a
//   second kernel sums the partials in split order and applies the scale, so
//   the result is deterministic with no atomics;
// - ragged HW and C edges are zero-filled on load and masked on store.
//
// Plain C interface, bound with ctypes: the function returns cudaGetLastError()
// after its launches so that a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 64;     // output tile edge
constexpr int kChunk = 16;    // HW rows staged per shared-memory pass
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// grid: x = column tile, y = row tile, z = n * splits + split
template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const T* __restrict__ f, float* __restrict__ ws, int hw, int c,
                    int splits, int rows_per_split) {
  __shared__ __align__(16) float a_s[kChunk][kTile];
  __shared__ __align__(16) float b_s[kChunk][kTile];

  const int n = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int row0 = split * rows_per_split;
  const int row1 = min(hw, row0 + rows_per_split);
  const int ci0 = blockIdx.y * kTile;
  const int cj0 = blockIdx.x * kTile;
  const T* fn = f + (size_t)n * hw * c;

  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = row0; k0 < row1; k0 += kChunk) {
#pragma unroll
    for (int q = 0; q < (kChunk * kTile) / kThreads; ++q) {
      const int idx = t + q * kThreads;
      const int r = idx / kTile;
      const int col = idx % kTile;
      const int row = k0 + r;
      const bool row_ok = row < row1;
      const int ca = ci0 + col;
      const int cb = cj0 + col;
      const size_t base = (size_t)row * c;
      a_s[r][col] = (row_ok && ca < c) ? to_f32(fn[base + ca]) : 0.f;
      b_s[r][col] = (row_ok && cb < c) ? to_f32(fn[base + cb]) : 0.f;
    }
    __syncthreads();
    // Sum each chunk on its own, then add it to the running total: the rounding
    // error of a long split grows with (rows / kChunk + kChunk), not with rows.
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&a_s[k][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&b_s[k][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

  float* out = ws + ((size_t)n * splits + split) * c * c;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = ci0 + ty * 4 + i;
    if (ci >= c) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cj = cj0 + tx * 4 + j;
      if (cj < c) out[(size_t)ci * c + cj] = acc[i][j];
    }
  }
}

// One thread per output element; sums the split partials in split order.
__global__ void gram_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                   int n_batch, int cc, int splits, float scale) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n_batch * cc) return;
  const size_t n = idx / cc;
  const size_t e = idx % cc;
  const float* p = ws + n * splits * (size_t)cc + e;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += p[(size_t)k * cc];
  out[idx] = s * scale;
}

template <typename T>
int launch(const void* f, float* ws, float* out, int n, int hw, int c, int splits,
           int rows_per_split, float scale, cudaStream_t stream) {
  const int tiles = (c + kTile - 1) / kTile;
  dim3 grid(tiles, tiles, n * splits);
  gram_partial_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(f), ws, hw, c,
                                                        splits, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = (size_t)n * c * c;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  gram_reduce_kernel<<<blocks, threads, 0, stream>>>(ws, out, n, c * c, splits, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. ws holds n * splits * c * c floats.
int ast_gram(const void* f, void* ws, void* out, int dtype, int n, int hw, int c, int splits,
             int rows_per_split, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return launch<float>(f, w, o, n, hw, c, splits, rows_per_split, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(f, w, o, n, hw, c, splits, rows_per_split, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ast_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
