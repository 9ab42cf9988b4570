// Batched normalized Gram matrix, G[n] = F[n]^T F[n] * scale, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel artist_style_transfer_tpu/ops/pallas/gram_kernel.py
// (gram_matrix_pallas). F[n] is the (HW, C) row-major view of an NHWC feature
// map (f32 or bf16), G is (C, C) f32.
//
// What bounds it: a Gram is HW*C*(C+1) distinct FLOPs against a few MB of
// input, so HBM bounds the small-C taps and the tensor cores the large-C ones.
// Design:
// - one block computes one tile (ti, tj) of G with ti <= tj over one split of
//   the HW axis: 64x64 with one warpgroup, or 128x128 with two (the wrapper's
//   plan picks 128 where there is work enough, as it reads F half as often);
//   the epilogue writes the tile and its mirror (transposed through shared
//   memory, so both stores are coalesced). A diagonal tile loads its F slice
//   once and uses it as both operands;
// - 128-byte stages of F rows (32 f32 rows or 64 bf16 rows) go through a ring
//   of cp.async stages, 3 to 10 deep as shared memory allows (16-byte copies,
//   zero-filled at ragged edges; scalar loads where C is not a multiple of 16
//   bytes);
// - F's tile is MN-major (channels contiguous). wgmma takes bf16 operands
//   MN-major, so a bf16 stage lands in the 128-byte-swizzled MN-major layout
//   and wgmma reads it in place. It takes TF32 operands only K-major, so a
//   converter pass reads each f32 stage and writes it K-major, swizzled, into
//   one of two tile sets: stage it + 1 is converted while the wgmma of stage
//   it runs;
// - f32 input runs 3xTF32: the converter splits each value a into
//   big = tf32(a) and small = tf32(a - big), and wgmma m64nNk8 sums
//   small*big + big*small + big*big in f32, which keeps about 22 mantissa
//   bits per product, as f32 does; no single TF32 pass exists. A diagonal
//   tile needs two passes: it computes Z = B^T B + 2 B^T S and the epilogue
//   writes (Z + Z^T) / 2 = B^T B + B^T S + S^T B. bf16 input runs one
//   wgmma m64nNk16 pass;
// - 8 stages are summed in the tensor cores' accumulator and then added to
//   the running total, so rounding grows with the rows of a split / 8 stages
//   + 8 stages, not with the rows of a split;
// - split-K over HW in one launch: every split writes its partial tile to a
//   workspace; the last block to arrive at a group of 8 splits (a counter,
//   reset to 0 afterwards) sums the group's partials in split order, and the
//   last group to finish sums the group sums in group order, scales and
//   writes G. Deterministic: the sums have no atomics, only the counters.
//
// Plain C interface, bound with ctypes: the function returns cudaGetLastError()
// after its launch so that a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 8;     // split partials summed per group (two-level sum)
constexpr int kKBytes = 128;  // bytes of K per stage: one 128-byte swizzle row

// A block computes a kTile x kTile tile of G, 64 or 128, with one warpgroup
// per 64 rows; wgmma is m64 n(kTile).
template <int kTile> struct Cfg {
  static constexpr int kThreads = 2 * kTile;
  static constexpr int kOpBytes = kTile * kKBytes;  // one K-major operand tile
  static constexpr int kAcc = kTile / 2;            // accumulator floats a thread
  // Dynamic shared memory, flag included: two 64-blocks or one 128-block an SM.
  static constexpr int kSmem = (kTile == 64 ? 112 : 224) * 1024 + 16;
};

template <typename T> struct Traits;
template <> struct Traits<float> {
  static constexpr int kVec = 4;  // elements per 16-byte copy
  static constexpr int kOps = 4;  // K-major tiles: A big, A small, B big, B small
};
template <> struct Traits<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr int kOps = 0;  // wgmma reads the MN-major stage itself
};
template <typename T> constexpr int kRows = kKBytes / (int)sizeof(T);  // HW rows per stage
// Shared memory: for f32 two sets of K-major operand tiles (one feeds wgmma
// while the other is written), then the ring of stages, then the arrival flag.
template <typename T, int kTile> constexpr int kOpsSet = Traits<T>::kOps * Cfg<kTile>::kOpBytes;
template <typename T, int kTile>
constexpr int kRingBytes = Cfg<kTile>::kSmem - 16 - 2 * kOpsSet<T, kTile>;

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) { return __float2bfloat16(0.f); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cvt.rna.tf32.f32 in two integer operations: round the 13 low mantissa bits
// to nearest, ties away from zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a K-major tile with
// 128-byte rows and the 128-byte swizzle (chunk index XOR row % 8).
__device__ __forceinline__ int swizzled(int row, int chunk) {
  return row * kKBytes + ((chunk ^ (row & 7)) << 4);
}

// Element offset of (row r, column col) in a stage. f32: row-major
// [kRows][kTile], for the converter. bf16: what wgmma reads MN-major, one
// [kRows rows][128 B] block per 64 columns (8 KB apart), its 16-byte chunks
// swizzled by row % 8 (the 128-byte swizzle).
template <int kTile>
__device__ __forceinline__ int stage_offset(int r, int col, float) {
  return r * kTile + col;
}
template <int kTile>
__device__ __forceinline__ int stage_offset(int r, int col, __nv_bfloat16) {
  constexpr int kR = kRows<__nv_bfloat16>;
  return (col >> 6) * (kR * 64) + r * 64 + ((((col >> 3) & 7) ^ (r & 7)) << 3) + (col & 7);
}

// Stage rows [row, row + kRows) x columns [col0, col0 + kTile) of F[n] into
// dst at stage_offset; rows at or past row1 and columns at or past c read as 0.
template <typename T, int kTile>
__device__ __forceinline__ void load_stage(T* dst, const T* __restrict__ fn, int row, int row1,
                                           int col0, int c, bool vec_ok) {
  constexpr int kVec = Traits<T>::kVec, kR = kRows<T>, kThreads = Cfg<kTile>::kThreads;
  if (vec_ok) {  // c % kVec == 0 and F 16-byte aligned: whole chunks are in or out
    constexpr int kPerRow = kTile / kVec;
#pragma unroll
    for (int i = 0; i < kR * kPerRow / kThreads; ++i) {
      const int q = threadIdx.x + i * kThreads;
      const int r = q / kPerRow, v = q % kPerRow;
      const int col = col0 + v * kVec;
      const bool ok = row + r < row1 && col < c;
      const T* src = ok ? fn + (size_t)(row + r) * c + col : fn;
      cp_async16(dst + stage_offset<kTile>(r, v * kVec, T()), src, ok ? 16 : 0);
    }
  } else {
    for (int q = threadIdx.x; q < kR * kTile; q += kThreads) {
      const int r = q / kTile, col = col0 + q % kTile;
      const bool ok = row + r < row1 && col < c;
      dst[stage_offset<kTile>(r, q % kTile, T())] = ok ? fn[(size_t)(row + r) * c + col] : zero_of(T());
    }
  }
}

// stage[32][kTile] (k, m) f32 -> K-major swizzled big[m][k] and small[m][k]
// TF32 bit patterns, small scaled by `small_scale` (1, or 2 for a diagonal
// tile). A thread writes 4 consecutive k of one m as one 16-byte chunk.
template <int kTile>
__device__ __forceinline__ void convert(const float* raw, unsigned char* big,
                                        unsigned char* small, float small_scale) {
  constexpr int kThreads = Cfg<kTile>::kThreads;
  const int m = threadIdx.x & (kTile - 1);
#pragma unroll
  for (int chunk = threadIdx.x / kTile; chunk < 8; chunk += kThreads / kTile) {
    uint32_t b[4], s[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = raw[(chunk * 4 + j) * kTile + m];
      b[j] = to_tf32(x);
      s[j] = to_tf32((x - __uint_as_float(b[j])) * small_scale);
    }
    const int off = swizzled(m, chunk);
    *reinterpret_cast<uint4*>(big + off) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(small + off) = make_uint4(s[0], s[1], s[2], s[3]);
  }
}

// wgmma shared-memory descriptor with the 128-byte swizzle. K-major tiles:
// 8-row groups 1024 bytes apart (SBO); LBO is unused. MN-major stages: 8-row
// K groups 1024 bytes apart (SBO) and 64-column blocks kMnBlock bytes apart
// (LBO).
__device__ __forceinline__ uint64_t desc(const unsigned char* p, uint32_t lbo = 16,
                                         uint32_t sbo = 1024) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}
template <int kMnBlock>
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* p) {
  return desc(p, kMnBlock, 1024);
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
// The compiler takes the wgmma asm's accumulator outputs as written when the
// asm issues; they are written when wgmma_wait returns. This fence keeps
// every other use of the accumulator on its side of the issue and the wait.
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define AST_D32(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define AST_R32 \
  "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" "}"
#define AST_D64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define AST_R64 \
  "{" "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" "}"

// d (+)= A B over one K step: A is 64 x K, B is K x N (N = 64 or 128), both
// K-major in shared memory; d is overwritten when accumulate is 0.
__device__ __forceinline__ void wgmma_step(float (&d)[32], uint64_t a, uint64_t b, int accumulate,
                                           float) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " AST_R32 ", %32, %33, p, 1, 1;\n}\n"
      : AST_D32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_step(float (&d)[32], uint64_t a, uint64_t b, int accumulate,
                                           __nv_bfloat16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " AST_R32
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : AST_D32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_step(float (&d)[64], uint64_t a, uint64_t b, int accumulate,
                                           float) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " AST_R64 ", %64, %65, p, 1, 1;\n}\n"
      : AST_D64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_step(float (&d)[64], uint64_t a, uint64_t b, int accumulate,
                                           __nv_bfloat16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " AST_R64
      ", %64, %65, p, 1, 1, 1, 1;\n}\n"
      : AST_D64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// part (+)= the stage's product for this warpgroup's 64 rows, over 4 K steps
// of 32 bytes each: f32 (k8 TF32) from the K-major tiles `ops` (A big, A
// small, B big, B small); `fresh` starts part from 0.
template <bool kDiag, int kTile>
__device__ __forceinline__ void mma_stage(float (&part)[Cfg<kTile>::kAcc],
                                          const unsigned char* ops, bool fresh, float) {
  constexpr int kOp = Cfg<kTile>::kOpBytes;
  const int wg_rows = (threadIdx.x >> 7) * 64 * kKBytes;  // this warpgroup's rows of A
  const unsigned char *ab = ops + wg_rows, *as = ops + kOp + wg_rows;
  const unsigned char *bb = kDiag ? ops : ops + 2 * kOp, *bs = kDiag ? ops + kOp : ops + 3 * kOp;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int o = 32 * k, add = k > 0 || !fresh;
    if (kDiag) {  // Z = B^T B + 2 B^T S: `bs` holds 2 * small
      wgmma_step(part, desc(ab + o), desc(bs + o), add, 0.f);
      wgmma_step(part, desc(ab + o), desc(bb + o), 1, 0.f);
    } else {
      wgmma_step(part, desc(as + o), desc(bb + o), add, 0.f);
      wgmma_step(part, desc(ab + o), desc(bs + o), 1, 0.f);
      wgmma_step(part, desc(ab + o), desc(bb + o), 1, 0.f);
    }
  }
}
// bf16: from the MN-major stage itself (both operands transposed); a K step
// of 16 rows is two 8-row groups, 2 KB.
template <bool kDiag, int kTile>
__device__ __forceinline__ void mma_stage(float (&part)[Cfg<kTile>::kAcc],
                                          const unsigned char* stage, bool fresh, __nv_bfloat16) {
  constexpr int kMn = kRows<__nv_bfloat16> * kKBytes;  // one 64-column block
  const unsigned char* a = stage + (threadIdx.x >> 7) * kMn;
  const unsigned char* b = kDiag ? stage : stage + (kTile / 64) * kMn;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wgmma_step(part, desc_mn<kMn>(a + 2048 * k), desc_mn<kMn>(b + 2048 * k), k > 0 || !fresh,
               __nv_bfloat16());
}

template <bool kDiag, int kTile>
__device__ __forceinline__ void convert_stage(const float* raw, unsigned char* ops) {
  constexpr int kOp = Cfg<kTile>::kOpBytes;
  convert<kTile>(raw, ops, ops + kOp, kDiag ? 2.f : 1.f);
  if (!kDiag) convert<kTile>(raw + kRows<float> * kTile, ops + 2 * kOp, ops + 3 * kOp, 1.f);
}

// acc += F[row0:row1, ci0:ci0+kTile]^T F[row0:row1, cj0:cj0+kTile] for this
// warpgroup's rows, f32, one 128-byte stage of F rows at a time. The ring holds
// single-operand stages for a diagonal tile (twice as many in flight) and
// operand pairs otherwise. The wgmma of stage it runs on the tensor cores
// while stage it + 1 is converted into the other set of K-major tiles; part
// is added to acc every kFold stages.
template <typename T, bool kDiag, int kTile>
__device__ __forceinline__ void main_loop(float (&acc)[Cfg<kTile>::kAcc], unsigned char* ops,
                                          T* ring, const T* __restrict__ fn, int row0, int row1,
                                          int ci0, int cj0, int c, bool vec_ok) {
  constexpr int kR = kRows<T>, kAcc = Cfg<kTile>::kAcc;
  constexpr int kSlotElems = (kDiag ? 1 : 2) * kR * kTile;
  constexpr int kSlots = kRingBytes<T, kTile> / (kSlotElems * (int)sizeof(T));
  static_assert(kSlots >= 3, "the ring keeps two stages in flight");
  constexpr int kFold = 8;
  const int chunks = (row1 - row0 + kR - 1) / kR;
  auto slot = [&](int it) { return ring + (it % kSlots) * kSlotElems; };
  auto load = [&](int it) {
    if (it < chunks) {
      load_stage<T, kTile>(slot(it), fn, row0 + it * kR, row1, ci0, c, vec_ok);
      if (!kDiag)
        load_stage<T, kTile>(slot(it) + kR * kTile, fn, row0 + it * kR, row1, cj0, c, vec_ok);
    }
    cp_async_commit();  // an empty group past the end keeps the wait counts uniform
  };
  auto convert = [&](int it) {
    convert_stage<kDiag, kTile>(slot(it), ops + (it & 1) * kOpsSet<T, kTile>);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

#pragma unroll
  for (int s = 0; s < kSlots - 1; ++s) load(s);
  cp_async_wait<kSlots - 2>();
  __syncthreads();
  convert(0);
  __syncthreads();
  float part[kAcc];
  for (int it = 0; it < chunks; ++it) {
    fence_operand(part);
    wgmma_fence();
    mma_stage<kDiag, kTile>(part, ops + (it & 1) * kOpsSet<T, kTile>, it % kFold == 0, T());
    wgmma_commit();
    fence_operand(part);
    load(it + kSlots - 1);  // into the slot stage it - 1 left
    if (it + 1 < chunks) {
      cp_async_wait<kSlots - 2>();
      wgmma_wait<1>();  // stage it - 1's wgmma is done: its tile set is free
      __syncthreads();  // stage it + 1 has landed for every thread
      convert(it + 1);
    }
    if ((it + 1) % kFold == 0 || it + 1 == chunks) {
      wgmma_wait<0>();
      fence_operand(part);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
    }
    __syncthreads();  // the tile set of stage it + 1 is complete for every thread
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The same for bf16, whose stages wgmma reads as they land: no conversion
// and no tile sets. The slot of stage it - 2 is refilled once every
// warpgroup's wgmma of stage it - 2 is done, so one barrier a stage suffices.
template <bool kDiag, int kTile>
__device__ __forceinline__ void main_loop_direct(float (&acc)[Cfg<kTile>::kAcc],
                                                 __nv_bfloat16* ring,
                                                 const __nv_bfloat16* __restrict__ fn, int row0,
                                                 int row1, int ci0, int cj0, int c, bool vec_ok) {
  using T = __nv_bfloat16;
  constexpr int kR = kRows<T>, kAcc = Cfg<kTile>::kAcc;
  constexpr int kSlotElems = (kDiag ? 1 : 2) * kR * kTile;
  constexpr int kSlots = kRingBytes<T, kTile> / (kSlotElems * (int)sizeof(T));
  static_assert(kSlots >= 4, "the ring keeps two stages in flight");
  constexpr int kFold = 8;
  const int chunks = (row1 - row0 + kR - 1) / kR;
  auto slot = [&](int it) { return ring + (it % kSlots) * kSlotElems; };
  auto load = [&](int it) {
    if (it < chunks) {
      load_stage<T, kTile>(slot(it), fn, row0 + it * kR, row1, ci0, c, vec_ok);
      if (!kDiag)
        load_stage<T, kTile>(slot(it) + kR * kTile, fn, row0 + it * kR, row1, cj0, c, vec_ok);
    }
    cp_async_commit();  // an empty group past the end keeps the wait counts uniform
  };

#pragma unroll
  for (int s = 0; s < kSlots - 2; ++s) load(s);
  float part[kAcc];
  for (int it = 0; it < chunks; ++it) {
    cp_async_wait<kSlots - 3>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // stage it is visible to wgmma; stage it - 2's wgmma is done everywhere
    load(it + kSlots - 2);  // into the slot stage it - 2 left
    fence_operand(part);
    wgmma_fence();
    mma_stage<kDiag, kTile>(part, reinterpret_cast<const unsigned char*>(slot(it)),
                            it % kFold == 0, T());
    wgmma_commit();
    fence_operand(part);
    if ((it + 1) % kFold == 0 || it + 1 == chunks) {
      wgmma_wait<0>();
      fence_operand(part);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
    } else {
      wgmma_wait<1>();  // stage it - 1's wgmma is done
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// s = sum over k < count of src[k * kTile^2 + e], k in order, for this
// thread's elements e of a tile (float4 i = threadIdx.x + q * kThreads).
template <int kTile, int kQ>
__device__ __forceinline__ void sum_tiles(const float* __restrict__ src, int count,
                                          float4 (&s)[kQ]) {
  constexpr int kThreads = Cfg<kTile>::kThreads;
  static_assert(kTile * kTile == kThreads * 4 * kQ, "kQ float4 a thread");
  constexpr int kUnroll = 16 / kQ;  // 16 float4 loads in flight a thread
#pragma unroll
  for (int q = 0; q < kQ; ++q) s[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < count; k += kUnroll) {
    float4 v[kUnroll][kQ];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        if (k + u < count)
          v[u][q] = __ldcg(reinterpret_cast<const float4*>(src + (size_t)(k + u) * kTile * kTile) +
                           threadIdx.x + q * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        if (k + u < count) {
          s[q].x += v[u][q].x;
          s[q].y += v[u][q].y;
          s[q].z += v[u][q].z;
          s[q].w += v[u][q].w;
        }
  }
}

// Arrive at counter *cnt as one of `expected` blocks; true in the last one to
// arrive, which resets the counter. Every thread of the block must call it.
__device__ __forceinline__ bool arrive_last(int* cnt, int expected, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *flag = atomicAdd(cnt, 1) == expected - 1;
    if (*flag) *cnt = 0;
  }
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  return true;
}

// grid: x = split, y = upper-triangle tile index p (row-major over ti <= tj,
// as gram_kernel.tile_pairs lists them), z = image. Cfg<kTile>::kSmem bytes
// of dynamic shared memory: the operand tile sets, the ring (which the
// epilogue reuses) and the arrival flag.
template <typename T, int kTile>
__global__ void __launch_bounds__(Cfg<kTile>::kThreads)
gram_tile_kernel(const T* __restrict__ f, float* __restrict__ ws, int* __restrict__ counters,
                 float* __restrict__ out, int hw, int c, int splits, int rows_per_split,
                 float scale, bool vec_ok) {
  constexpr int kThreads = Cfg<kTile>::kThreads, kAcc = Cfg<kTile>::kAcc;
  constexpr int kQ = kTile * kTile / (4 * kThreads);  // float4 of a tile a thread
  extern __shared__ __align__(1024) unsigned char ops[];  // swizzled tiles need 1024-byte alignment
  if (smem_u32(ops) % 1024 != 0) __trap();
  T* ring = reinterpret_cast<T*>(ops + 2 * kOpsSet<T, kTile>);
  float* tile_s = reinterpret_cast<float*>(ring);  // [kTile][kTile + 1], after the main loop
  int* is_last = reinterpret_cast<int*>(ops + Cfg<kTile>::kSmem - 16);

  const int tiles = (c + kTile - 1) / kTile;
  int ti = 0, rem = blockIdx.y;
  while (rem >= tiles - ti) {
    rem -= tiles - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const bool diag = ti == tj;
  const int ci0 = ti * kTile, cj0 = tj * kTile;
  const int n = blockIdx.z, split = blockIdx.x;
  const int row0 = split * rows_per_split;
  const int row1 = min(hw, row0 + rows_per_split);
  const T* fn = f + (size_t)n * hw * c;

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  if constexpr (Traits<T>::kOps == 0) {
    if (diag)
      main_loop_direct<true, kTile>(acc, ring, fn, row0, row1, ci0, cj0, c, vec_ok);
    else
      main_loop_direct<false, kTile>(acc, ring, fn, row0, row1, ci0, cj0, c, vec_ok);
  } else {
    if (diag)
      main_loop<T, true, kTile>(acc, ops, ring, fn, row0, row1, ci0, cj0, c, vec_ok);
    else
      main_loop<T, false, kTile>(acc, ops, ring, fn, row0, row1, ci0, cj0, c, vec_ok);
  }

  // acc[i] holds tile element (16 * warp + g + 8 * (i % 4 / 2), 8 * (i / 4) + 2 * t + i % 2),
  // warp = threadIdx.x / 32 (warpgroup w holds rows 64w..64w+63), g = lane / 4, t = lane % 4.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_base = 16 * warp + (lane >> 2), col_base = 2 * (lane & 3);
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      tile_s[(row_base + 8 * ((i >> 1) & 1)) * (kTile + 1) + 8 * (i >> 2) + col_base + (i & 1)] =
          acc[i] * scale;
  } else {
    // Split partials are summed in two fixed-order levels: the last block of
    // each group of kGroup splits sums the group's partials; the last group
    // sums the group sums. ws per tile: splits partials, then groups sums.
    const int groups = (splits + kGroup - 1) / kGroup;
    const int tile_id = n * gridDim.y + blockIdx.y;
    float* tile_ws = ws + (size_t)tile_id * (splits + groups) * (kTile * kTile);
    int* tile_cnt = counters + tile_id * (groups + 1);
    float* mine = tile_ws + (size_t)split * (kTile * kTile);
#pragma unroll
    for (int i = 0; i < kAcc; i += 2)
      *reinterpret_cast<float2*>(mine + (row_base + 8 * ((i >> 1) & 1)) * kTile + 8 * (i >> 2) +
                                 col_base) = make_float2(acc[i], acc[i + 1]);
    const int group = split / kGroup;
    const int first = group * kGroup;
    const int members = min(kGroup, splits - first);
    if (!arrive_last(tile_cnt + group, members, is_last)) return;
    float4 s[kQ];
    sum_tiles<kTile>(tile_ws + (size_t)first * (kTile * kTile), members, s);
    if (groups > 1) {
      float4* gsum = reinterpret_cast<float4*>(tile_ws + (size_t)(splits + group) * (kTile * kTile));
#pragma unroll
      for (int q = 0; q < kQ; ++q) gsum[threadIdx.x + q * kThreads] = s[q];
      if (!arrive_last(tile_cnt + groups, groups, is_last)) return;
      sum_tiles<kTile>(tile_ws + (size_t)splits * (kTile * kTile), groups, s);
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int e = (threadIdx.x + q * kThreads) * 4;
      float* d = tile_s + (e / kTile) * (kTile + 1) + e % kTile;
      d[0] = s[q].x * scale;
      d[1] = s[q].y * scale;
      d[2] = s[q].z * scale;
      d[3] = s[q].w * scale;
    }
  }
  __syncthreads();

  float* gn = out + (size_t)n * c * c;
  if (diag) {  // G = (Z + Z^T) / 2: the symmetric part of the tile
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int i = e / kTile, j = e % kTile;
      if (ci0 + i < c && cj0 + j < c)
        gn[(size_t)(ci0 + i) * c + cj0 + j] =
            0.5f * (tile_s[i * (kTile + 1) + j] + tile_s[j * (kTile + 1) + i]);
    }
    return;
  }
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int i = e / kTile, j = e % kTile;  // row-major: coalesced along j
    if (ci0 + i < c && cj0 + j < c) gn[(size_t)(ci0 + i) * c + cj0 + j] = tile_s[i * (kTile + 1) + j];
  }
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int j = e / kTile, i = e % kTile;  // mirror: coalesced along i
    if (ci0 + i < c && cj0 + j < c) gn[(size_t)(cj0 + j) * c + ci0 + i] = tile_s[i * (kTile + 1) + j];
  }
}

template <typename T, int kTile>
int launch(const void* f, float* ws, int* counters, float* out, int n, int hw, int c, int splits,
           int rows_per_split, float scale, cudaStream_t stream) {
  constexpr int kSmem = Cfg<kTile>::kSmem;
  static_assert(kTile * (kTile + 1) * 4 <= kRingBytes<T, kTile>, "the epilogue tile fits the ring");
  const cudaError_t attr = cudaFuncSetAttribute(
      gram_tile_kernel<T, kTile>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tiles = (c + kTile - 1) / kTile;
  const bool vec_ok = c % Traits<T>::kVec == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0;
  dim3 grid(splits, tiles * (tiles + 1) / 2, n);
  gram_tile_kernel<T, kTile><<<grid, Cfg<kTile>::kThreads, kSmem, stream>>>(
      static_cast<const T*>(f), ws, counters, out, hw, c, splits, rows_per_split, scale, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int tile, const void* f, float* ws, int* counters, float* out, int n, int hw, int c,
           int splits, int rows_per_split, float scale, cudaStream_t stream) {
  if (tile == 64) return launch<T, 64>(f, ws, counters, out, n, hw, c, splits, rows_per_split, scale, stream);
  if (tile == 128)
    return launch<T, 128>(f, ws, counters, out, n, hw, c, splits, rows_per_split, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; tile: 64 or 128, the edge of G's tiles.
// With splits > 1, ws holds n * tiles * (splits + groups) * tile^2 floats and
// counters n * tiles * (groups + 1) zeroed ints (tiles = T(T+1)/2,
// T = ceil(c / tile), groups = ceil(splits / 8)); the kernel leaves the
// counters at 0.
int ast_gram(const void* f, void* ws, void* counters, void* out, int dtype, int tile, int n,
             int hw, int c, int splits, int rows_per_split, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  int* k = static_cast<int*>(counters);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return launch<float>(tile, f, w, k, o, n, hw, c, splits, rows_per_split, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(tile, f, w, k, o, n, hw, c, splits, rows_per_split, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ast_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
