// Int8 convolution with exact int32 accumulation for Hopper (sm_90a): kernel K2.
//
// Replaces the XLA int8 convolutions of the JAX package
// (conv_general_dilated on int8 operands with preferred_element_type=int32):
// artist_style_transfer_tpu/models/transformer_q.py:62 (_conv_i8),
// artist_style_transfer_tpu/ops/qconv.py:68 (_conv_i8, under conv2d_frozen_int8)
// and artist_style_transfer_tpu/models/resnet_q.py:111 (_conv_i8_dyn).
// PyTorch has no int8 convolution on CUDA.
//
// What it computes: an implicit-GEMM convolution, M = N*Ho*Wo output pixels,
// N = C_out, K = kh*kw*C_in, over int8 NHWC activations and int8
// (C_out, kh, kw, C_in) weights, with the exact int32 sum. The input is read
// unpadded: zero or reflect padding (pads lo, hi on both axes) and the
// zero-insert lhs dilation of a transpose conv live in the address arithmetic,
// so no padded or dilated int8 copy is made. Three epilogues: the int32 sum;
// its bf16 (int32 -> f32 -> bf16, each to nearest even, as XLA converts);
// the dequant acc * (s_in * sw[c]) + b[c] in f32 (no fused multiply-add),
// stored as f32 or bf16.
//
// What bounds it on the H100: at the slice's shapes an int8 conv moves about
// as many bytes (int8 in, s32 or bf16 out) as it needs operations at the
// dense int8 rate (1979 TOPS), so both bounds are close; the transpose convs
// also read 3 of 4 taps as inserted zeros, which the kernel multiplies and the
// bound does not count.
//
// Design, simple and right first:
// - one block of 4 warps computes a 128 x BN tile of the output (BN = 64, or 32
//   where C_out is 32), each warp a (128 / warps_m) x (BN / warps_n) tile with
//   mma.sync m16n8k32 s8 x s8 -> s32 on the tensor cores;
// - the K loop takes 32 input channels of one tap a step: each thread gathers
//   the 32 bytes of its output pixel's input row with two 16-byte cp.async
//   copies (zero-filled where the tap falls on padding or an inserted zero),
//   and the weight tile likewise, into a 4-stage ring in shared memory;
// - each 32-byte smem row swaps its two 16-byte halves by bit 2 of the row, so
//   the fragments' 32-bit loads of 8 rows hit 32 distinct banks;
// - C_in is a multiple of 32 (the wrapper checks), so a step never straddles a tap.
// wgmma and TMA are left for a later version.
//
// Plain C interface, bound with ctypes: ast_qconv returns cudaGetLastError()
// after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBM = 128;      // output pixels per block, one A row per thread
constexpr int kBK = 32;       // int8 reduction elements per stage: one mma k-step
constexpr int kStages = 4;    // cp.async ring depth
constexpr int kThreads = 128;  // 4 warps

struct Params {
  const int8_t* x;   // (n, h, w, cin)
  const int8_t* wt;  // (cout, kh, kw, cin)
  void* out;         // (n, ho, wo, cout)
  int n, h, w, cin, cout, kh, kw, stride, pad_lo, dil, reflect, ho, wo, epilogue;
  const float* s_in;  // () dequant: the input's scale
  const float* sw;    // (cout,) dequant: the weight scales
  const float* bias;  // (cout,) dequant, or null
};

enum Epilogue { kInt32 = 0, kBf16 = 1, kDequantF32 = 2, kDequantBf16 = 3 };

// Byte offset of half `h` (16 bytes) of smem row `row`: halves swapped by bit 2 of the row.
__device__ __forceinline__ int swz(int row, int h) {
  return row * kBK + ((h ^ ((row >> 2) & 1)) << 4);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* buf, int row, int h, int t) {
  return *reinterpret_cast<const uint32_t*>(buf + swz(row, h) + t * 4);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Input index along one axis for padded-dilated position `pos`, or valid = false
// where it falls on zero padding or an inserted zero. Reflect never dilates, and
// its pads are under the size (the wrapper checks both).
__device__ __forceinline__ int source_index(int pos, int pad_lo, int dil, int size, int reflect,
                                            bool* valid) {
  int q = pos - pad_lo;
  if (reflect) {
    q = q < 0 ? -q : q;
    q = q >= size ? 2 * (size - 1) - q : q;
    *valid = true;
    return q;
  }
  if (q < 0 || q % dil != 0) {
    *valid = false;
    return 0;
  }
  q /= dil;
  *valid = q < size;
  return q;
}

template <int BN, int kWarpsN>
__global__ void __launch_bounds__(kThreads) qconv_kernel(const Params p) {
  constexpr int kWarpsM = 4 / kWarpsN;
  constexpr int kWM = kBM / kWarpsM;  // rows of a warp's tile
  constexpr int kWN = BN / kWarpsN;   // columns of a warp's tile
  constexpr int kMI = kWM / 16;
  constexpr int kNJ = kWN / 8;
  __shared__ __align__(128) int8_t a_s[kStages][kBM * kBK];
  __shared__ __align__(128) int8_t b_s[kStages][BN * kBK];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp / kWarpsN, warp_n = warp % kWarpsN;
  const int g = lane >> 2, t = lane & 3;
  const int m_total = p.n * p.ho * p.wo;
  const int block_m = blockIdx.x * kBM, block_n = blockIdx.y * BN;

  // This thread's A row: one output pixel, fixed over the K loop.
  const int m = block_m + tid;
  const bool m_ok = m < m_total;
  int img = 0, oh = 0, ow = 0;
  if (m_ok) {
    img = m / (p.ho * p.wo);
    const int rest = m - img * p.ho * p.wo;
    oh = rest / p.wo;
    ow = rest - oh * p.wo;
  }
  const int8_t* x_img = p.x + static_cast<size_t>(img) * p.h * p.w * p.cin;
  const int steps_per_tap = p.cin / kBK;
  const int k_steps = p.kh * p.kw * steps_per_tap;
  const size_t k_total = static_cast<size_t>(p.kh) * p.kw * p.cin;

  auto load_stage = [&](int stage, int kt) {
    const int tap = kt / steps_per_tap;
    const int c0 = (kt - tap * steps_per_tap) * kBK;
    const int r = tap / p.kw, s = tap - r * p.kw;
    bool vh, vw;
    const int ih = source_index(oh * p.stride + r, p.pad_lo, p.dil, p.h, p.reflect, &vh);
    const int iw = source_index(ow * p.stride + s, p.pad_lo, p.dil, p.w, p.reflect, &vw);
    const bool ok = m_ok && vh && vw;
    const int8_t* src = ok ? x_img + (static_cast<size_t>(ih) * p.w + iw) * p.cin + c0 : p.x;
    cp_async16(&a_s[stage][swz(tid, 0)], src, ok);
    cp_async16(&a_s[stage][swz(tid, 1)], src + (ok ? 16 : 0), ok);
    for (int c = tid; c < BN * 2; c += kThreads) {
      const int row = c >> 1, h = c & 1, co = block_n + row;
      const bool okb = co < p.cout;
      const int8_t* wsrc =
          okb ? p.wt + static_cast<size_t>(co) * k_total + static_cast<size_t>(kt) * kBK + h * 16
              : p.wt;
      cp_async16(&b_s[stage][swz(row, h)], wsrc, okb);
    }
  };

  int acc[kMI][kNJ][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_steps) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_steps; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed for every thread; stage kt - 1 is free to refill
    const int next = kt + kStages - 1;
    if (next < k_steps) load_stage(next % kStages, next);
    cp_async_commit();

    const int8_t* a = a_s[kt % kStages];
    const int8_t* b = b_s[kt % kStages];
    uint32_t af[kMI][4], bf[kNJ][2];
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
      const int row = warp_m * kWM + i * 16 + g;
      af[i][0] = lds32(a, row, 0, t);
      af[i][1] = lds32(a, row + 8, 0, t);
      af[i][2] = lds32(a, row, 1, t);
      af[i][3] = lds32(a, row + 8, 1, t);
    }
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int col = warp_n * kWN + j * 8 + g;
      bf[j][0] = lds32(b, col, 0, t);
      bf[j][1] = lds32(b, col, 1, t);
    }
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) mma_s8(acc[i][j], af[i], bf[j]);
  }
  cp_async_wait<0>();

  const float s_in = p.epilogue >= kDequantF32 ? *p.s_in : 0.0f;
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int col = block_n + warp_n * kWN + j * 8 + t * 2;
      if (col >= p.cout) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = block_m + warp_m * kWM + i * 16 + g + half * 8;
        if (row >= m_total) continue;
        const int v0 = acc[i][j][half * 2], v1 = acc[i][j][half * 2 + 1];
        const size_t o = static_cast<size_t>(row) * p.cout + col;
        if (p.epilogue == kInt32) {
          *reinterpret_cast<int2*>(static_cast<int*>(p.out) + o) = make_int2(v0, v1);
        } else if (p.epilogue == kBf16) {
          __nv_bfloat162 h2;
          h2.x = __float2bfloat16_rn(__int2float_rn(v0));
          h2.y = __float2bfloat16_rn(__int2float_rn(v1));
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + o) = h2;
        } else {
          float y0 = __fmul_rn(__int2float_rn(v0), __fmul_rn(s_in, p.sw[col]));
          float y1 = __fmul_rn(__int2float_rn(v1), __fmul_rn(s_in, p.sw[col + 1]));
          if (p.bias != nullptr) {
            y0 = __fadd_rn(y0, p.bias[col]);
            y1 = __fadd_rn(y1, p.bias[col + 1]);
          }
          if (p.epilogue == kDequantF32) {
            *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) = make_float2(y0, y1);
          } else {
            __nv_bfloat162 h2;
            h2.x = __float2bfloat16_rn(y0);
            h2.y = __float2bfloat16_rn(y1);
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + o) = h2;
          }
        }
      }
    }
  }
}

template <int BN, int kWarpsN>
int launch(const Params& p, cudaStream_t stream) {
  const int m_total = p.n * p.ho * p.wo;
  const dim3 grid((m_total + kBM - 1) / kBM, (p.cout + BN - 1) / BN);
  qconv_kernel<BN, kWarpsN><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (n, h, w, cin) int8 and wt (cout, kh, kw, cin) int8, contiguous; out (n, ho, wo, cout):
// int32 (epilogue 0), bf16 (1, 3) or f32 (2). cin a multiple of 32, cout even; pads lo on
// the low side of both axes (hi is implied by ho and wo); reflect (1) needs dil 1 and pads
// under the size. s_in, sw and bias are read by the dequant epilogues only; bias may be null.
int ast_qconv(const void* x, const void* wt, void* out, int n, int h, int w, int cin, int cout,
              int kh, int kw, int stride, int pad_lo, int dil, int reflect, int ho, int wo,
              int epilogue, const void* s_in, const void* sw, const void* bias, void* stream) {
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.wt = static_cast<const int8_t*>(wt);
  p.out = out;
  p.n = n;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.cout = cout;
  p.kh = kh;
  p.kw = kw;
  p.stride = stride;
  p.pad_lo = pad_lo;
  p.dil = dil;
  p.reflect = reflect;
  p.ho = ho;
  p.wo = wo;
  p.epilogue = epilogue;
  p.s_in = static_cast<const float*>(s_in);
  p.sw = static_cast<const float*>(sw);
  p.bias = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout <= 32) return launch<32, 1>(p, s);
  return launch<64, 2>(p, s);
}

}  // extern "C"
