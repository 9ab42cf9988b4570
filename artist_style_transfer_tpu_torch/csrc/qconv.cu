// Int8 convolution with exact int32 accumulation for Hopper (sm_90a): kernel K2.
//
// Replaces the XLA int8 convolutions of the JAX package
// (conv_general_dilated on int8 operands with preferred_element_type=int32):
// artist_style_transfer_tpu/models/transformer_q.py:62 (_conv_i8),
// artist_style_transfer_tpu/ops/qconv.py:68 (_conv_i8, under conv2d_frozen_int8)
// and artist_style_transfer_tpu/models/resnet_q.py:111 (_conv_i8_dyn).
// PyTorch has no int8 convolution on CUDA.
//
// What it computes: an implicit-GEMM convolution over int8 NHWC activations and
// int8 (C_out, kh, kw, C_in) weights with the exact int32 sum, M = output pixels,
// N = C_out, K = taps * C_in. The input is read unpadded: zero or reflect padding
// and the zero-insert lhs dilation of a transpose conv live in the address
// arithmetic. Three epilogues: the int32 sum; its bf16 (int32 -> f32 -> bf16, each
// to nearest even, as XLA converts); the dequant acc * (s_in * sw[c]) + b[c] in f32
// (__fmul_rn / __fadd_rn, no fused multiply-add), stored as f32 or bf16.
//
// What bounds it on the H100: at the main path's shapes an int8 conv moves about as
// many bytes (int8 in, bf16 or s32 out) as it needs operations at the dense int8
// rate (1979 TOPS), so the bound is bytes or operations within 2x of each other.
// What the kernel adds on top, measured on the card (PERF.md): every block pays a
// fixed set-up and epilogue, and every pipeline stage a block-wide barrier, a
// proxy fence and the cp.async and wgmma waits, which at these small K extents (1
// to 36 units of 128 bytes) cost as much as the MMA; and an implicit GEMM gathers
// each input row once per tap. So the scalar work of a thread is kept small (no
// runtime division: the host passes multiply-shift divisors; the tables in a device
// buffer read once a block; the tap and channel of a stage advanced incrementally),
// a stage may hold several K units, and the 3x3 convs may read a halo once per tap.
//
// Design (the host plan, ops/cuda/qconv_plan.py, computes everything shape-bound
// and picks the variant by a cost model fitted on the card):
// - Sub-pixel split. An lhs dilation d makes P = d / gcd(stride, d) classes of
//   outputs per axis; each class is an ordinary conv over the undilated input with
//   its own taps and input offsets, and writes the outputs (P a + ph, P b + pw).
//   So the inserted zeros are never multiplied. All classes run in one launch: the
//   grid's x walks every class's M tiles times the N tiles, and a block finds its
//   class in the class table. A class's K is (its taps, C_in): tap t's weights sit
//   at offset t * C_in of each weight row, so no repack.
// - The tensor cores: wgmma.mma_async m64nBNk32 s8 x s8 -> s32, B K-major in shared
//   memory with the 128-byte swizzle (the layout, descriptor and fences the Gram
//   kernel, gram.cu, runs on this card). A block of BM / 64 warpgroups (BM = 64,
//   128 or 256) computes a BM x BN tile (BN = 32, 64, 128 or 256).
// - A, gather mode: a K unit is 128 bytes of (tap, C_in) for BM output pixels,
//   copied by every thread in 16-byte cp.async pieces (zero-filled on padding, past
//   M and past the class's K) into the 128-byte-swizzled layout B uses.
// - A, halo mode (class stride 1 or 2; C_in 32, 64 or a multiple of 128): each
//   warpgroup computes an 8x8 patch of outputs and holds the patch's input halo,
//   one 128-channel slice at a time, as planes of 16 bytes a pixel (stride 2: even
//   columns, then odd ones). A K unit is one tap of one slice: the wgmma reads A
//   straight out of the halo through a descriptor without swizzle (core matrices of
//   8 pixels x 16 bytes, K planes hp * 16 bytes apart, output rows stride * halo
//   width * 16 apart), so a pixel is copied once a slice, not once a tap.
// - The pipeline: stages of `group` K units in a ring of 3 to 8 slots in dynamic
//   shared memory, filled slots - 2 stages ahead; a slot is refilled once the
//   wgmma that read it is done on every warpgroup, so one barrier a stage suffices,
//   and a stage's wgmma is issued before the copies of a later stage, so the two
//   overlap. B, the weight tile, is a plain 2D tile of the (C_out, kh*kw*C_in)
//   matrix and comes by cp.async too: a TMA descriptor would need the driver API on
//   the host and saves only B's address arithmetic; TMA's im2col mode has no
//   reflect padding, so A stays a gather.
// - Split-K where the tiles under-fill the 132 SMs: grid z splits each class's K
//   units; each split adds its partial tile into an int32 workspace with
//   reductions (exact: integer addition is associative); the last block to arrive
//   at the tile's counter reads the sum back, zeroes the workspace and the counter
//   for the next launch, and runs the epilogue once. One launch either way.
// - Staged epilogue: the tile goes through shared memory (the ring, free by then)
//   and out in 16-byte pieces of each output row.
//
// Plain C interface, bound with ctypes: ast_qconv reads the plan's host ints and
// its device table and returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kKStep = 128;       // int8 reduction bytes a stage: one swizzled 128-byte row
constexpr int kMaxClasses = 16;   // table sizes; qconv_plan.MAX_CLASSES / MAX_TAPS
constexpr int kMaxTaps = 64;
constexpr int kClassInts = 24;    // qconv_plan.CLASS_INTS: ints a class in the device table
constexpr int kPatch = 8;         // qconv_plan.PATCH: a warpgroup's halo-mode outputs, 8 x 8
constexpr int kMaxSmem = 232448;  // shared memory a block may have on the H100 (227 KB)

enum Epilogue { kInt32 = 0, kBf16 = 1, kDequantF32 = 2, kDequantBf16 = 3 };

// The device table (qconv_plan.QconvPlan.table): kMaxClasses classes of kClassInts,
// then kMaxTaps taps of [weight tap r * kw + s, input offset h, input offset w].
enum ClassField { kTile0 = 0, kNh, kNw, kPh, kPw, kTapFirst, kTaps, kSteps, kPlaneMul,
                  kPlaneShr, kNwMul, kNwShr, kHaloH, kHaloW, kHaloEven, kMinDh, kMinDw,
                  kPatchW, kPatchesMul, kPatchesShr, kPatchWMul, kPatchWShr, kHaloWMul,
                  kHaloWShr };
constexpr int kTapTable = kMaxClasses * kClassInts;

struct Params {
  const int8_t* x;   // (n, h, w, cin)
  const int8_t* wt;  // (cout, kh, kw, cin)
  void* out;         // (n, ho, wo, cout)
  int* ws;           // split-K partial tiles, zero between launches
  int* counters;     // split-K arrivals, zero between launches
  const float* s_in;  // () dequant: the input's scale
  const float* sw;    // (cout,) dequant: the weight scales
  const float* bias;  // (cout,) dequant, or null
  const int* table;   // the class and tap table, on the device
  int n, h, w, cin, cout, ktot, ho, wo, period, cstride, reflect, splits, nclasses, n_tiles, slots;
  unsigned tiles_mul, tiles_shr;  // division by n_tiles
  int halo_region;  // halo mode: shared memory of the halos, a multiple of 1024
  int halo_pixels;  // halo mode: pixels of the largest class's halo (a buffer's size / slice)
  int group;  // K units a stage: gather 128-byte K steps, halo taps
};

template <int BM, int BN>
struct Cfg {
  static constexpr int kThreads = 2 * BM;  // BM / 64 warpgroups
  static constexpr int kStageA = BM * kKStep;
  static constexpr int kUnit = (BM + BN) * kKStep;  // gather: one K unit's A and B tiles
  static constexpr int kRowsPass = kThreads / 8;  // rows one pass of 16-byte columns covers
  static constexpr int kRowsA = BM / kRowsPass;   // A rows a thread copies a stage: 4
  static constexpr int kOutRow = BN * 4 + 32;     // bytes of a staged output row
  static constexpr int kStaged = BM * kOutRow;
  // Up to 128 registers a thread where the accumulators leave room, so that two
  // blocks of 256 threads share an SM and one's barriers hide under the other's MMA.
  static constexpr int kMinBlocks = BM <= 128 && BN <= 128 ? 2 : 1;
  static constexpr int kAcc = BN / 2;  // s32 accumulators a thread: m64nBN over 128 threads
};

// Dynamic shared memory of a launch: gather mode the ring of A and B stages, halo
// mode the halos and a ring of B stages (a stage `group` K units); or the staged
// output tile if larger; + 1024 to align the swizzled tiles. qconv_plan.smem_bytes.
template <int BM, int BN, bool HALO>
int smem_bytes(const Params& p) {
  using C = Cfg<BM, BN>;
  const int body = HALO ? p.halo_region + p.slots * p.group * BN * kKStep
                         : p.slots * p.group * C::kUnit;
  return (body > C::kStaged ? body : C::kStaged) + 1024;
}

// n / d for 0 <= n < 2^31 with the host's (mul, shr) of d (qconv_plan.fast_divisor).
__device__ __forceinline__ int fast_div(int n, unsigned mul, unsigned shr) {
  return static_cast<int>((__umulhi(static_cast<unsigned>(n), mul) + static_cast<unsigned>(n)) >> shr);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Wait until at most n (0 to 5: the ring's 3 to 8 slots) groups are pending.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    default: cp_async_wait<5>(); break;
  }
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a K-major tile with
// 128-byte rows and the 128-byte swizzle (chunk index XOR row % 8).
__device__ __forceinline__ int swizzled(int row, int chunk) {
  return row * kKStep + ((chunk ^ (row & 7)) << 4);
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte swizzle:
// 8-row groups 1024 bytes apart (SBO); LBO unused.
__device__ __forceinline__ uint64_t desc(const unsigned char* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// ... of a K-major operand without swizzle: core matrices of 8 rows x 16 bytes, each
// 128 contiguous bytes; `k_stride` bytes between core matrices along K (LBO),
// `m_stride` between 8-row groups (SBO).
__device__ __forceinline__ uint64_t desc_plain(const unsigned char* p, uint32_t k_stride,
                                               uint32_t m_stride) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(k_stride >> 4) << 16) |
         ((uint64_t)(m_stride >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// The compiler takes the wgmma asm's accumulator outputs as written when the asm
// issues; they are written when wgmma_wait returns. This fence keeps every other
// use of the accumulator on its side of the issue and the wait.
template <int N>
__device__ __forceinline__ void fence_operand(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A B over one k32 step: A 64 x 32 bytes, B BN x 32 bytes, both K-major.
__device__ __forceinline__ void wgmma_s8(int (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// The epilogue of one accumulator pair into the staged tile: `es` bytes an element.
template <int EPI>
__device__ __forceinline__ void stage_pair(unsigned char* dst, int v0, int v1, int gc, int cout,
                                           float s_in, const float* sw, const float* bias) {
  if constexpr (EPI == kInt32) {
    *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
  } else if constexpr (EPI == kBf16) {
    __nv_bfloat162 h2;
    h2.x = __float2bfloat16_rn(__int2float_rn(v0));
    h2.y = __float2bfloat16_rn(__int2float_rn(v1));
    *reinterpret_cast<__nv_bfloat162*>(dst) = h2;
  } else {
    if (gc >= cout) return;  // C_out is even: gc + 1 < C_out too
    float y0 = __fmul_rn(__int2float_rn(v0), __fmul_rn(s_in, sw[gc]));
    float y1 = __fmul_rn(__int2float_rn(v1), __fmul_rn(s_in, sw[gc + 1]));
    if (bias != nullptr) {
      y0 = __fadd_rn(y0, bias[gc]);
      y1 = __fadd_rn(y1, bias[gc + 1]);
    }
    if constexpr (EPI == kDequantF32) {
      *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
    } else {
      __nv_bfloat162 h2;
      h2.x = __float2bfloat16_rn(y0);
      h2.y = __float2bfloat16_rn(y1);
      *reinterpret_cast<__nv_bfloat162*>(dst) = h2;
    }
  }
}

// Stage the accumulators in shared memory with the EPI epilogue, then write each
// valid row out in 16-byte pieces (4-byte stores at a ragged C_out).
template <int BM, int BN, int EPI>
__device__ __forceinline__ void epilogue(const Params& p, const int (&acc)[Cfg<BM, BN>::kAcc],
                                         unsigned char* smem, const int* opix, int n0, int rbase,
                                         int cbase) {
  using C = Cfg<BM, BN>;
  constexpr int kEs = (EPI == kInt32 || EPI == kDequantF32) ? 4 : 2;
  const float s_in = EPI >= kDequantF32 ? *p.s_in : 0.0f;
#pragma unroll
  for (int i = 0; i < C::kAcc; i += 2) {
    const int r = rbase + 8 * ((i >> 1) & 1), c = 8 * (i >> 2) + cbase;
    stage_pair<EPI>(smem + r * C::kOutRow + c * kEs, acc[i], acc[i + 1], n0 + c, p.cout, s_in,
                    p.sw, p.bias);
  }
  __syncthreads();
  constexpr int kPer = 16 / kEs;     // output channels a piece
  constexpr int kPieces = BN / kPer;  // pieces a staged row
  const int cols = min(BN, p.cout - n0);
  const bool vec = (p.cout * kEs) % 16 == 0;
  for (int q = threadIdx.x; q < BM * kPieces; q += C::kThreads) {
    const int r = q / kPieces, c0 = (q % kPieces) * kPer;
    const int o = opix[r];
    if (o < 0 || c0 >= cols) continue;
    unsigned char* g =
        static_cast<unsigned char*>(p.out) + (static_cast<size_t>(o) * p.cout + n0 + c0) * kEs;
    const unsigned char* s = smem + r * C::kOutRow + c0 * kEs;
    if (vec && c0 + kPer <= cols) {
      *reinterpret_cast<uint4*>(g) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int e = 0; e < kPer && c0 + e < cols; e += 4 / kEs)
        *reinterpret_cast<uint32_t*>(g + e * kEs) = *reinterpret_cast<const uint32_t*>(s + e * kEs);
    }
  }
}

template <int BM, int BN, bool HALO>
__global__ void __launch_bounds__(Cfg<BM, BN>::kThreads, Cfg<BM, BN>::kMinBlocks)
qconv_kernel(const Params p, const int epi) {
  using C = Cfg<BM, BN>;
  constexpr int kWgs = BM / 64;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int tap_s[kMaxTaps * 3];
  __shared__ int opix_s[BM];  // output pixel of each tile row, -1 past the class's M
  __shared__ int last_s;
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* ring = HALO ? smem + p.halo_region : smem;  // halo mode: halos, then B

  const int tid = threadIdx.x, wg = tid >> 7;
  const int tile = fast_div(blockIdx.x, p.tiles_mul, p.tiles_shr);
  const int n0 = (blockIdx.x - tile * p.n_tiles) * BN;
  const int* table = p.table;
  int ci = 0;
  for (int c = 1; c < p.nclasses; ++c)
    if (tile >= __ldg(table + c * kClassInts + kTile0)) ci = c;
  const int* cls = table + ci * kClassInts;
  const int nh = __ldg(cls + kNh), nw = __ldg(cls + kNw);
  const int ph = __ldg(cls + kPh), pw = __ldg(cls + kPw), ntaps = __ldg(cls + kTaps);
  const int tile_in_class = tile - __ldg(cls + kTile0);
  const int steps_class = __ldg(cls + kSteps);
  const int kb = static_cast<int>(static_cast<long long>(blockIdx.z) * steps_class / p.splits);
  const int ke = static_cast<int>(static_cast<long long>(blockIdx.z + 1) * steps_class / p.splits);
  const int steps = ke - kb;
  const int cin = p.cin, cin16 = cin >> 4, h = p.h, w = p.w, reflect = p.reflect;
  const int cstride = p.cstride;

  for (int i = tid; i < ntaps * 3; i += C::kThreads)
    tap_s[i] = __ldg(table + kTapTable + 3 * __ldg(cls + kTapFirst) + i);

  // Gather mode: this thread copies 16-byte column `col` of every stage's A rows
  // row0 + i * kRowsPass (the column-0 thread of a row records its output pixel).
  const int col = tid & 7, row0 = tid >> 3;
  const int8_t* xr[C::kRowsA];
  int hb[C::kRowsA], wb[C::kRowsA];
  unsigned row_ok = 0;
  // Halo mode: warpgroup g computes the 8x8 patch (py, px) of image img; its halo holds
  // the input rows hy0 + [0, halo_h) and columns wx0 + [0, halo_w) (stride 2: the even
  // columns, then the odd ones), one plane of 16 bytes a pixel for each 16 channels.
  const int halo_h = __ldg(cls + kHaloH), halo_w = __ldg(cls + kHaloW);
  const int halo_even = __ldg(cls + kHaloEven), min_dh = __ldg(cls + kMinDh),
            min_dw = __ldg(cls + kMinDw);
  const int hp = halo_h * halo_w;  // pixels of this class's halo
  const int slice = cin < kKStep ? cin : kKStep;  // bytes of a slice's channels
  const int cc_shift = slice == 128 ? 3 : (slice == 64 ? 2 : 1);  // 16-byte chunks, log2
  int himg[kWgs], hy0[kWgs], wx0[kWgs];
  if constexpr (HALO) {
    const int patch_w = __ldg(cls + kPatchW);
    const unsigned pm = __ldg(cls + kPatchesMul), ps = __ldg(cls + kPatchesShr);
    const unsigned pwm = __ldg(cls + kPatchWMul), pws = __ldg(cls + kPatchWShr);
    const int per_img = ((nh + kPatch - 1) / kPatch) * patch_w;
#pragma unroll
    for (int g = 0; g < kWgs; ++g) {
      const int patch = tile_in_class * kWgs + g;
      const int img = fast_div(patch, pm, ps), rest = patch - img * per_img;
      const int py = fast_div(rest, pwm, pws), px = rest - py * patch_w;
      himg[g] = img;
      hy0[g] = py * kPatch;  // the patch's first output row and column, in the class grid
      wx0[g] = px * kPatch;
    }
    for (int r = tid; r < BM; r += C::kThreads) {
      const int g = r >> 6, m = r & 63;
      int img = himg[0], oy = hy0[0], ox = wx0[0];
#pragma unroll
      for (int q = 1; q < kWgs; ++q)
        if (g == q) {
          img = himg[q];
          oy = hy0[q];
          ox = wx0[q];
        }
      oy += m >> 3;
      ox += m & 7;
      opix_s[r] = img < p.n && oy < nh && ox < nw
                      ? (img * p.ho + p.period * oy + ph) * p.wo + p.period * ox + pw
                      : -1;
    }
  } else {
    const int plane = nh * nw;
    const unsigned plane_mul = __ldg(cls + kPlaneMul), plane_shr = __ldg(cls + kPlaneShr);
    const unsigned nw_mul = __ldg(cls + kNwMul), nw_shr = __ldg(cls + kNwShr);
    const int m0 = tile_in_class * BM;
#pragma unroll
    for (int i = 0; i < C::kRowsA; ++i) {
      const int r = row0 + i * C::kRowsPass, m = m0 + r;
      const int img = fast_div(m, plane_mul, plane_shr), rest = m - img * plane;
      const int a = fast_div(rest, nw_mul, nw_shr), b = rest - a * nw;
      xr[i] = p.x;
      hb[i] = wb[i] = 0;
      int o = -1;
      if (img < p.n) {  // past the class's M otherwise
        xr[i] = p.x + static_cast<size_t>(img) * h * w * cin;
        hb[i] = a * cstride;
        wb[i] = b * cstride;
        row_ok |= 1u << i;
        o = (img * p.ho + p.period * a + ph) * p.wo + p.period * b + pw;
      }
      if (col == 0) opix_s[r] = o;
    }
  }
  __syncthreads();  // the tap table is in shared memory

  // The stage this thread fills next. Gather: its 16-byte chunk kc of the class's K, as
  // tap t and chunk c16 of that tap's channels, advanced 8 chunks a stage. Halo: tap t
  // of slice sl, advanced one tap a stage.
  int kc = kb * 8 + col, t, c16, sl;
  if constexpr (HALO) {
    sl = kb / (ntaps > 0 ? ntaps : 1);  // once a block
    t = kb - sl * ntaps;
    c16 = 0;
  } else {
    t = kc / cin16;  // once a block
    c16 = kc - t * cin16;
    sl = 0;
  }
  // A stage is `group` K units; the ring's slots hold whole stages.
  const int group = p.group;
  constexpr int kUnitBytes = HALO ? BN * kKStep : C::kUnit;
  const int slot_bytes = group * kUnitBytes;
  int filled = 0;  // K units filled so far
  auto load_unit = [&](unsigned char* unit) {
    unsigned char* sb = unit + (HALO ? 0 : C::kStageA);
    if constexpr (HALO) {
      const int soff = sl * kKStep;  // the slice's first channel
      if (t == 0 || filled == 0) {   // the slice's halo, with its first stage
        const int hmul = __ldg(cls + kHaloWMul), hshr = __ldg(cls + kHaloWShr);
        unsigned char* buf = smem + (sl & 1) * kWgs * p.halo_pixels * slice;
#pragma unroll
        for (int g = 0; g < kWgs; ++g) {
          if (himg[g] >= p.n) continue;  // past the class's patches: never stored
          const int8_t* ximg = p.x + static_cast<size_t>(himg[g]) * h * w * cin + soff;
          unsigned char* hbuf = buf + g * p.halo_pixels * slice;
          const int ih0 = hy0[g] * cstride + min_dh, iw0 = wx0[g] * cstride + min_dw;
          for (int q = tid; q < (hp << cc_shift); q += C::kThreads) {
            const int pix = q >> cc_shift, c = q & ((1 << cc_shift) - 1);
            const int hy = fast_div(pix, hmul, hshr), hx = pix - hy * halo_w;
            const int cx = halo_even == 0 ? hx : (hx < halo_even ? 2 * hx : 2 * (hx - halo_even) + 1);
            int ih = ih0 + hy, iw = iw0 + cx;
            bool ok = true;
            if (reflect) {
              ih = ih < 0 ? -ih : ih;
              ih = ih >= h ? 2 * (h - 1) - ih : ih;
              iw = iw < 0 ? -iw : iw;
              iw = iw >= w ? 2 * (w - 1) - iw : iw;
            } else {
              ok = static_cast<unsigned>(ih) < static_cast<unsigned>(h) &&
                   static_cast<unsigned>(iw) < static_cast<unsigned>(w);
            }
            cp_async16(hbuf + c * (hp * 16) + pix * 16,
                       ok ? ximg + (static_cast<size_t>(ih) * w + iw) * cin + c * 16 : p.x,
                       ok ? 16 : 0);
          }
        }
      }
      const int8_t* wsrc = p.wt + static_cast<size_t>(tap_s[3 * t]) * cin + soff;
      for (int q = tid; q < (BN << cc_shift); q += C::kThreads) {
        const int row = q >> cc_shift, c = q & ((1 << cc_shift) - 1);
        const int co = n0 + row;
        const bool ok = co < p.cout;
        cp_async16(sb + swizzled(row, c), ok ? wsrc + static_cast<size_t>(co) * p.ktot + c * 16 : p.wt,
                   ok ? 16 : 0);
      }
      if (++t == ntaps) {
        t = 0;
        ++sl;
      }
    } else {
      unsigned char* sa = sb - C::kStageA;
      const bool kin = kc < ntaps * cin16;  // past the class's K: zero-filled
      const int tt = kin ? t : 0;
      const int dh = tap_s[3 * tt + 1], dw = tap_s[3 * tt + 2];
      const size_t coff = static_cast<size_t>(c16) * 16;
#pragma unroll
      for (int i = 0; i < C::kRowsA; ++i) {
        int ih = hb[i] + dh, iw = wb[i] + dw;
        bool ok = kin && ((row_ok >> i) & 1u);
        if (reflect) {  // pads under the size (the plan checks)
          ih = ih < 0 ? -ih : ih;
          ih = ih >= h ? 2 * (h - 1) - ih : ih;
          iw = iw < 0 ? -iw : iw;
          iw = iw >= w ? 2 * (w - 1) - iw : iw;
        } else {
          ok = ok && static_cast<unsigned>(ih) < static_cast<unsigned>(h) &&
               static_cast<unsigned>(iw) < static_cast<unsigned>(w);
        }
        const int8_t* src = ok ? xr[i] + (static_cast<size_t>(ih) * w + iw) * cin + coff : p.x;
        cp_async16(sa + swizzled(row0 + i * C::kRowsPass, col), src, ok ? 16 : 0);
      }
      const int8_t* wsrc = p.wt + static_cast<size_t>(tap_s[3 * tt]) * cin + coff;
      for (int row = row0; row < BN; row += C::kRowsPass) {
        const int co = n0 + row;
        const bool ok = kin && co < p.cout;
        cp_async16(sb + swizzled(row, col), ok ? wsrc + static_cast<size_t>(co) * p.ktot : p.wt,
                   ok ? 16 : 0);
      }
      kc += 8;
      c16 += 8;
      while (c16 >= cin16) {
        c16 -= cin16;
        ++t;
      }
    }
    ++filled;
  };
  auto load_stage = [&](int slot) {
    for (int u = 0; u < group && filled < steps; ++u) load_unit(ring + slot * slot_bytes + u * kUnitBytes);
  };

  int acc[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) acc[i] = 0;
  // The MMA state: gather, nothing; halo, the tap and slice of the stage in the MMA.
  int mt = 0, msl = 0;
  if constexpr (HALO) {
    msl = kb / (ntaps > 0 ? ntaps : 1);
    mt = kb - msl * ntaps;
  }
  const uint32_t plane_bytes = hp * 16;  // halo: between 16-byte chunk planes (K)
  const uint32_t row_bytes = cstride * halo_w * 16;  // halo: between output rows (M)
  const int ksteps = slice >> 5;  // halo: k32 steps a stage

  // Stages run slots - 2 ahead: the slot stage it + slots - 2 fills is the one
  // stage it - 2 left, whose wgmma every warpgroup has waited for.
  const int slots = p.slots;
  const int stages = (steps + group - 1) / group;
  for (int s = 0; s < slots - 2; ++s) {
    if (s < stages) load_stage(s);
    cp_async_commit();  // an empty group past the end keeps the wait counts uniform
  }
  int use = 0, fill = slots - 2;  // ring slots of stage it and of stage it + slots - 2
  for (int it = 0; it < stages; ++it) {
    cp_async_wait_pending(slots - 3);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // stage it is visible to wgmma; stage it - 2's wgmma is done everywhere
    fence_operand(acc);
    wgmma_fence();
    const int units = min(group, steps - it * group);
    for (int u = 0; u < units; ++u) {
      const unsigned char* unit = ring + use * slot_bytes + u * kUnitBytes;
      if constexpr (HALO) {
        const int e = tap_s[3 * mt + 2] - min_dw;
        const int cx = halo_even == 0 ? e : ((e & 1) ? halo_even : 0) + (e >> 1);
        const unsigned char* a = smem + ((msl & 1) * kWgs + wg) * p.halo_pixels * slice +
                                 ((tap_s[3 * mt + 1] - min_dh) * halo_w + cx) * 16;
        for (int k = 0; k < ksteps; ++k)
          wgmma_s8(acc, desc_plain(a + 2 * k * plane_bytes, plane_bytes, row_bytes),
                   desc(unit + 32 * k));
        if (++mt == ntaps) {
          mt = 0;
          ++msl;
        }
      } else {
        const unsigned char* a = unit + wg * 64 * kKStep;
        const unsigned char* b = unit + C::kStageA;
#pragma unroll
        for (int k = 0; k < 4; ++k) wgmma_s8(acc, desc(a + 32 * k), desc(b + 32 * k));
      }
    }
    wgmma_commit();
    fence_operand(acc);
    if (it + slots - 2 < stages) load_stage(fill);  // while the tensor cores run stage it
    cp_async_commit();
    use = use + 1 == slots ? 0 : use + 1;
    fill = fill + 1 == slots ? 0 : fill + 1;
    wgmma_wait<1>();  // stage it - 1's wgmma is done
  }
  wgmma_wait<0>();
  fence_operand(acc);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the staged output

  // acc[i] holds tile element (64 * wg + 16 * warp + g + 8 * (i % 4 / 2), 8 * (i / 4) + 2 * t + i % 2),
  // warp = the warp in its warpgroup, g = lane / 4, t = lane % 4.
  const int lane = tid & 31;
  const int rbase = wg * 64 + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int cbase = 2 * (lane & 3);
  if (p.splits > 1) {
    int* wst = p.ws + static_cast<size_t>(blockIdx.x) * (BM * BN);
#pragma unroll
    for (int i = 0; i < C::kAcc; i += 2) {
      int* d = wst + (rbase + 8 * ((i >> 1) & 1)) * BN + 8 * (i >> 2) + cbase;
      atomicAdd(d, acc[i]);
      atomicAdd(d + 1, acc[i + 1]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      last_s = atomicAdd(p.counters + blockIdx.x, 1) == p.splits - 1;
      if (last_s) p.counters[blockIdx.x] = 0;
    }
    __syncthreads();
    if (!last_s) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < C::kAcc; i += 2) {
      int* d = wst + (rbase + 8 * ((i >> 1) & 1)) * BN + 8 * (i >> 2) + cbase;
      acc[i] = __ldcg(d);
      acc[i + 1] = __ldcg(d + 1);
      __stcg(d, 0);
      __stcg(d + 1, 0);
    }
  }
  switch (epi) {
    case kInt32: epilogue<BM, BN, kInt32>(p, acc, smem, opix_s, n0, rbase, cbase); break;
    case kBf16: epilogue<BM, BN, kBf16>(p, acc, smem, opix_s, n0, rbase, cbase); break;
    case kDequantF32: epilogue<BM, BN, kDequantF32>(p, acc, smem, opix_s, n0, rbase, cbase); break;
    default: epilogue<BM, BN, kDequantBf16>(p, acc, smem, opix_s, n0, rbase, cbase); break;
  }
}

template <int BM, int BN, bool HALO>
int launch(const Params& p, int epi, int grid_x, cudaStream_t stream) {
  static bool attr_set[64] = {};  // the shared-memory attribute, once a device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!attr_set[dev]) {  // allow all a block may have beside the static tables
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, qconv_kernel<BM, BN, HALO>);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(qconv_kernel<BM, BN, HALO>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem - static_cast<int>(fa.sharedSizeBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set[dev] = true;
  }
  const dim3 grid(grid_x, 1, p.splits);
  qconv_kernel<BM, BN, HALO>
      <<<grid, Cfg<BM, BN>::kThreads, smem_bytes<BM, BN, HALO>(p), stream>>>(p, epi);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN>
int launch(const Params& p, bool halo, int epi, int grid_x, cudaStream_t stream) {
  return halo ? launch<BM, BN, true>(p, epi, grid_x, stream)
              : launch<BM, BN, false>(p, epi, grid_x, stream);
}

}  // namespace

extern "C" {

// plan: the host block of qconv_plan.QconvPlan.args(): [n, h, w, cin, cout, kh*kw*cin,
// ho, wo, period, class stride, reflect, splits, classes, M tiles, N tiles, BM, BN, taps,
// ring slots, mul and shr dividing by N tiles, halo mode, the halos' shared memory, the
// largest halo's pixels, K units a stage, 0]; table: the device copy of QconvPlan.table(), 16 classes of the
// ClassField ints, then 64 taps of [weight tap, offset h, offset w]. x (n, h, w, cin) and
// wt (cout, kh, kw, cin) int8, contiguous and 16-byte aligned; out (n, ho, wo, cout):
// int32 (epilogue 0), bf16 (1, 3) or f32 (2). With splits > 1, ws holds M tiles * N tiles
// * BM * BN zeroed int32 and counters M tiles * N tiles zeroed ints; the kernel leaves
// both at 0. s_in, sw and bias are read by the dequant epilogues only; bias may be null.
int ast_qconv(const int* plan, const void* table, const void* x, const void* wt, void* out,
              void* ws, void* counters, const void* s_in, const void* sw, const void* bias,
              int epilogue, void* stream) {
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.wt = static_cast<const int8_t*>(wt);
  p.out = out;
  p.ws = static_cast<int*>(ws);
  p.counters = static_cast<int*>(counters);
  p.s_in = static_cast<const float*>(s_in);
  p.sw = static_cast<const float*>(sw);
  p.bias = static_cast<const float*>(bias);
  p.table = static_cast<const int*>(table);
  p.n = plan[0];
  p.h = plan[1];
  p.w = plan[2];
  p.cin = plan[3];
  p.cout = plan[4];
  p.ktot = plan[5];
  p.ho = plan[6];
  p.wo = plan[7];
  p.period = plan[8];
  p.cstride = plan[9];
  p.reflect = plan[10];
  p.splits = plan[11];
  p.nclasses = plan[12];
  const int m_tiles = plan[13];
  p.n_tiles = plan[14];
  const int bm = plan[15], bn = plan[16], ntaps = plan[17];
  p.slots = plan[18];
  p.tiles_mul = static_cast<unsigned>(plan[19]);
  p.tiles_shr = static_cast<unsigned>(plan[20]);
  const bool halo = plan[21] != 0;
  p.halo_region = plan[22];
  p.halo_pixels = plan[23];
  p.group = plan[24];
  if (p.nclasses < 1 || p.nclasses > kMaxClasses || ntaps < 0 || ntaps > kMaxTaps ||
      p.splits < 1 || p.cin % 32 != 0 || epilogue < kInt32 || epilogue > kDequantBf16 ||
      p.slots < 3 || p.slots > 8 || p.group < 1 || table == nullptr ||
      (halo && (p.cstride > 2 || p.halo_region % 1024 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid_x = m_tiles * p.n_tiles;
  switch (bm * 1000 + bn) {
    case 64032: return launch<64, 32>(p, halo, epilogue, grid_x, s);
    case 64064: return launch<64, 64>(p, halo, epilogue, grid_x, s);
    case 64128: return launch<64, 128>(p, halo, epilogue, grid_x, s);
    case 64256: return launch<64, 256>(p, halo, epilogue, grid_x, s);
    case 128032: return launch<128, 32>(p, halo, epilogue, grid_x, s);
    case 128064: return launch<128, 64>(p, halo, epilogue, grid_x, s);
    case 128128: return launch<128, 128>(p, halo, epilogue, grid_x, s);
    case 128256: return launch<128, 256>(p, halo, epilogue, grid_x, s);
    case 256032: return launch<256, 32>(p, halo, epilogue, grid_x, s);
    case 256064: return launch<256, 64>(p, halo, epilogue, grid_x, s);
    case 256128: return launch<256, 128>(p, halo, epilogue, grid_x, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
