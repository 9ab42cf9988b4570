// Fused instance norm of the int8 TransformerNet for Hopper (sm_90a):
// conv accumulator -> IN (+ReLU) -> bf16 (+ residual) -> int8 codes of the next conv.
//
// Replaces no TPU kernel: the JAX package's _in_act and _quant_act
// (artist_style_transfer_tpu/models/transformer_q.py) are XLA fusions. In the port
// the same chain was about 15 PyTorch passes over the full tensor a layer
// (models/transformer_q.py, in_act_q8_plain: the f32 cast, two means, the square,
// the centring, three multiply and add steps, the ReLU, the bf16 cast, the
// residual add, then the quantizer's cast, multiply, round, clamp and int8 cast),
// about 103 bytes an element for a bf16 accumulator.
//
// What bounds it on the H100: bytes. The statistics stay PyTorch's own reductions,
// summed in PyTorch's order, because the int8 TransformerNet is chaotic under the
// last bits of its statistics: with random weights, one ulp on every channel's mean
// moves the stylized image by 3.4 uint8 levels on average (256x256), so any other
// order of the sums is a different result. PyTorch sums a bf16 tensor into an f32
// accumulator (mean with dtype float32) in the order it sums the tensor's f32 copy, so
// the mean reads the accumulator as it is; the squares are written once in f32 by
// in_q8_square_kernel for PyTorch's mean of them. The rest is one pass. A call moves
// about 15 bytes an element (a bf16 accumulator: the mean reads 2; the squares read 2
// and write 4; their mean reads 4; the apply reads 2 and writes 1 of codes), 19 where
// a residual is added and the stream kept.
//
// Arithmetic, exactly the plain composition's, in separately rounded operations (no
// contraction into fused multiply-adds):
// - per (n, c): var = max(m2 - mean * mean, 0) and rstd = rsqrt(var + eps) in f32,
//   from PyTorch's f32 mean and mean of squares;
// - y = ((x - mean) * rstd) * gamma + beta, ReLU, rounded to bf16; with a residual
//   r, y = bf16(y + r); the codes int8(clamp(rint(y * inv_s), -127, 127)) from the
//   bf16-rounded y, as the plain quantizer reads the bf16 stream.
//
// Design: NHWC, so a pixel's C channels are contiguous. A thread owns 8 channels
// (one 16-byte bf16 vector, two for int32) and a few pixels, neighbouring threads on
// neighbouring 16-byte pieces; blockDim = C/8 * (256 / (C/8)) threads. The apply puts
// its loads (and the residual's) in flight first, 8 pixels a thread for bf16 and 4 for
// int32, then works out its 8 channels' rstd and keeps them, the means, gamma and beta
// in registers, and writes the stream and the codes as asked. (Staging the parameters
// in shared memory behind a barrier, to free registers, ran 1.8-3.6x slower on the
// card: the loads waited for the barrier.)
//
// Plain C interface, bound with ctypes; each function returns cudaGetLastError()
// after its launch so that a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;           // channels a thread owns
constexpr int kIters = 4;         // vectors a thread of the squares has in flight
constexpr int kMaxThreads = 256;  // a block; C/8 must divide into it

// The raw bits of one thread's 8 channels of one pixel.
template <typename T> struct Raw;
template <> struct Raw<__nv_bfloat16> {
  uint4 w[1];
};
template <> struct Raw<int32_t> {
  uint4 w[2];
};

template <typename T>
__device__ __forceinline__ Raw<T> load_raw(const T* p) {
  Raw<T> r;
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(r.w) / sizeof(uint4)); ++i) r.w[i] = __ldg(q + i);
  return r;
}

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

__device__ __forceinline__ void to_float(const Raw<__nv_bfloat16>& r, float (&v)[kVec]) {
  const uint32_t u[4] = {r.w[0].x, r.w[0].y, r.w[0].z, r.w[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = bf16_lo(u[i]);
    v[2 * i + 1] = bf16_hi(u[i]);
  }
}

__device__ __forceinline__ void to_float(const Raw<int32_t>& r, float (&v)[kVec]) {
  const uint32_t u[8] = {r.w[0].x, r.w[0].y, r.w[0].z, r.w[0].w,
                         r.w[1].x, r.w[1].y, r.w[1].z, r.w[1].w};
#pragma unroll
  for (int i = 0; i < kVec; ++i) v[i] = __int2float_rn(static_cast<int>(u[i]));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  // lo and hi are already bf16 values: their high 16 bits are the bf16 bits.
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xFFFF0000u);
}

// sq = f32(x)^2 over `vecs` vectors of 8 values, for PyTorch's mean of the squares.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
in_q8_square_kernel(const T* __restrict__ x, float* __restrict__ sq, long long vecs) {
  const long long v0 = (long long)blockIdx.x * kIters * blockDim.x + threadIdx.x;
  Raw<T> raw[kIters];
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const long long v = v0 + (long long)k * blockDim.x;
    if (v < vecs) raw[k] = load_raw(x + v * kVec);
  }
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const long long v = v0 + (long long)k * blockDim.x;
    if (v >= vecs) continue;
    float f[kVec];
    to_float(raw[k], f);
    float4* o = reinterpret_cast<float4*>(sq + v * kVec);
    o[0] = make_float4(__fmul_rn(f[0], f[0]), __fmul_rn(f[1], f[1]), __fmul_rn(f[2], f[2]),
                       __fmul_rn(f[3], f[3]));
    o[1] = make_float4(__fmul_rn(f[4], f[4]), __fmul_rn(f[5], f[5]), __fmul_rn(f[6], f[6]),
                       __fmul_rn(f[7], f[7]));
  }
}

// Pixels a thread of the apply has in flight: 8 bf16 vectors, 4 int32 pairs (registers).
template <typename T> constexpr int kApplyIters = sizeof(T) == 2 ? 8 : 4;

// y = ((x - mean) * rstd) * gamma + beta (+ReLU) -> bf16 (+ residual) -> the stream
// and the codes. mean and m2 are (n, c) f32; residual, out and codes may each be null
// (not both of the last two).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
in_q8_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                   const float* __restrict__ m2, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const __nv_bfloat16* __restrict__ residual,
                   const float* __restrict__ inv_s, __nv_bfloat16* __restrict__ out,
                   int8_t* __restrict__ codes, int hw, int c, int relu, float eps) {
  constexpr int kI = kApplyIters<T>;
  const int groups = c / kVec, lanes = blockDim.x / groups;
  const int t = threadIdx.x, ch = (t % groups) * kVec;
  const int n = blockIdx.y;
  const int p0 = blockIdx.x * kI * lanes + t / groups;
  const size_t base = (size_t)n * hw * c + ch;

  // The loads first, so that they are in flight while the parameters are worked out.
  Raw<T> raw[kI];
  uint4 res[kI];
#pragma unroll
  for (int k = 0; k < kI; ++k) {
    const int p = p0 + k * lanes;
    if (p < hw) {
      raw[k] = load_raw(x + base + (size_t)p * c);
      if (residual) res[k] = __ldg(reinterpret_cast<const uint4*>(residual + base + (size_t)p * c));
    }
  }
  float mu[kVec], rs[kVec], ga[kVec], be[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    mu[i] = __ldg(mean + (size_t)n * c + ch + i);
    float var = __fsub_rn(__ldg(m2 + (size_t)n * c + ch + i), __fmul_rn(mu[i], mu[i]));
    var = var < 0.f ? 0.f : var;
    rs[i] = rsqrtf(__fadd_rn(var, eps));
    ga[i] = __ldg(gamma + ch + i);
    be[i] = __ldg(beta + ch + i);
  }
  const float inv = inv_s ? *inv_s : 0.f;

#pragma unroll
  for (int k = 0; k < kI; ++k) {
    const int p = p0 + k * lanes;
    if (p >= hw) continue;
    float v[kVec];
    to_float(raw[k], v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float y = __fmul_rn(__fsub_rn(v[i], mu[i]), rs[i]);
      y = __fadd_rn(__fmul_rn(y, ga[i]), be[i]);
      if (relu && y < 0.f) y = 0.f;
      v[i] = round_bf16(y);
    }
    if (residual) {
      const uint32_t u[4] = {res[k].x, res[k].y, res[k].z, res[k].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = round_bf16(__fadd_rn(v[2 * i], bf16_lo(u[i])));
        v[2 * i + 1] = round_bf16(__fadd_rn(v[2 * i + 1], bf16_hi(u[i])));
      }
    }
    const size_t at = base + (size_t)p * c;
    if (out) {
      uint4 o;
      o.x = pack_bf16(v[0], v[1]);
      o.y = pack_bf16(v[2], v[3]);
      o.z = pack_bf16(v[4], v[5]);
      o.w = pack_bf16(v[6], v[7]);
      *reinterpret_cast<uint4*>(out + at) = o;
    }
    if (codes) {
      // clamp(rint(y * inv_s)) as clamp first (the bounds are whole numbers, so the two
      // orders agree), then rint by adding 1.5 * 2^23: the sum's last bits are the
      // rounded value (to nearest even) in two's complement.
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float r = fminf(fmaxf(__fmul_rn(v[i], inv), -127.f), 127.f);
        w[i / 4] |= (__float_as_uint(__fadd_rn(r, 12582912.f)) & 0xFFu) << (8 * (i % 4));
      }
      *reinterpret_cast<uint2*>(codes + at) = make_uint2(w[0], w[1]);
    }
  }
}

}  // namespace

extern "C" {

// x: `elems` int32 (x_int32 = 1) or bf16 values, 16-byte aligned, elems a multiple of
// 8; sq: elems f32, 16-byte aligned.
int ast_in_q8_square(const void* x, void* sq, int x_int32, long long elems, void* stream) {
  if (elems < kVec || elems % kVec != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long vecs = elems / kVec, per_block = (long long)kIters * kMaxThreads;
  const dim3 grid((unsigned)((vecs + per_block - 1) / per_block));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(sq);
  if (x_int32)
    in_q8_square_kernel<int32_t><<<grid, kMaxThreads, 0, s>>>(static_cast<const int32_t*>(x), o,
                                                               vecs);
  else
    in_q8_square_kernel<__nv_bfloat16><<<grid, kMaxThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), o, vecs);
  return static_cast<int>(cudaGetLastError());
}

// x (n, hw, c) int32 (x_int32 = 1) or bf16, contiguous and 16-byte aligned, c a multiple
// of 8 up to 2048; mean, m2 (n, c) f32: each (n, c)'s mean and mean of squares; gamma,
// beta (c) f32; residual (n, hw, c) bf16, 16-byte aligned, or null; inv_s one f32 or
// null (then codes must be null); out (n, hw, c) bf16 or null; codes (n, hw, c) int8 or
// null, not both null.
int ast_in_q8_apply(const void* x, const void* mean, const void* m2, const void* gamma,
                    const void* beta, const void* residual, const void* inv_s, void* out,
                    void* codes, int x_int32, int n, int hw, int c, int relu, float eps,
                    void* stream) {
  if (c < kVec || c % kVec != 0 || c / kVec > kMaxThreads || n < 1 || n > 65535 || hw < 1 ||
      (out == nullptr && codes == nullptr) || (codes != nullptr && inv_s == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = c / kVec, threads = groups * (kMaxThreads / groups);
  const int lanes = threads / groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mu = static_cast<const float*>(mean);
  const float* sq = static_cast<const float*>(m2);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  const __nv_bfloat16* r = static_cast<const __nv_bfloat16*>(residual);
  const float* inv = static_cast<const float*>(inv_s);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  int8_t* q = static_cast<int8_t*>(codes);
  if (x_int32) {
    const int per_block = kApplyIters<int32_t> * lanes;
    in_q8_apply_kernel<int32_t><<<dim3((hw + per_block - 1) / per_block, n), threads, 0, s>>>(
        static_cast<const int32_t*>(x), mu, sq, ga, be, r, inv, o, q, hw, c, relu, eps);
  } else {
    const int per_block = kApplyIters<__nv_bfloat16> * lanes;
    in_q8_apply_kernel<__nv_bfloat16>
        <<<dim3((hw + per_block - 1) / per_block, n), threads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), mu, sq, ga, be, r, inv, o, q, hw, c, relu, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
