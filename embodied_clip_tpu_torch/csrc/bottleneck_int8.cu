// Kernels K3, K4 and K5: the int8 bottlenecks of the CLIP ResNet trunk.
//
// Replaces (embodied_clip_tpu/ops/pallas/bottleneck_kernel.py):
//   K3 fused_stage1_int8     whole int8 stage 1 (3 bottlenecks, bf16 conv shortcut)
//   K4 fused_cb3_cb1_int8    block n's cb3 + residual + requant fused with block n+1's
//                            cb1 + requant
//   K5 fused_resblocks_int8  k stride-1 identity bottlenecks
// The host wrappers (embodied_clip_tpu_torch/ops/kernels/bottleneck_kernel.py) build
// K3 and K5 as short sequences of the launches below; K4 is one launch.
//
// A TPU core keeps a whole stage in VMEM; an RN50 stage-1 image (56·56·256 B s8) does
// not fit one SM's 227 KB, so here the activations between convs go through device
// memory (mostly L2) as s8 and every epilogue is fused into the conv that feeds it:
//   (a) gemm_s8_kernel<false>  s8×s8→s32 1×1 conv (a GEMM over pixel rows)
//   (b) gemm_s8_kernel<true>   s8 3×3 conv, stride 1, zero halo, as an implicit GEMM
//                              (K = 9·C)
//   (c) cb3_cb1_kernel         K4: a tile of pixel rows computes all C columns of
//                              cb3 + residual + requant into shared memory, then the
//                              next block's cb1 + requant from there; the block output
//                              is written once and never read back
//   (d) entry_kernel           K3's first launch: block 0's cb1 (s8, as (a)) and its 1×1
//                              conv shortcut (bf16 operands, f32 sum, signed s8
//                              requant) from one read of each x8 tile
//
// Arithmetic. Products are s8×s8 summed in s32 on the tensor cores
// (wgmma.mma_async m64nNk32.s32.s8.s8): exact in any order at every K (|acc| ≤
// 9·768·127² < 2³¹), so the TPU kernels' K ≤ 1024 bf16 route and K > 1024 s32 route are
// one route here, and no partial sum needs promoting. Epilogues follow the JAX graph's
// op order (embodied_clip_tpu/ops/quantize.py:443 and :597-609), each op rounded on its
// own:
//   v = float(acc)·S[n] + b[n];  v = v + float(res)·r_res;  q = trunc(clip(v / r + 0.5,
//   0, 127)); signed: y = v / r, y ± 0.5 by sign, clip ±127, trunc.
// __int2float_rn/__fmul_rn/__fadd_rn/__fdiv_rn keep nvcc from contracting them into
// FMAs, so the result equals PyTorch's elementwise ops on the same values bit for bit.
// The reciprocal requant (the JAX package's ECT_RECIP_REQUANT=1, ops/int8.py) is a
// template parameter RECIP of the requants where the TPU kernels take it (their
// `_unscale`): K4's two, K3's three block outputs ((c)'s out8 and the last (a)), and K5's
// s8 output (its last (a)). Every other requant divides under either setting, as theirs
// do: the (b) launches, K3's entry, K5's inner (a)/(c). There each thread takes 1 / r of
// the scale once (__frcp_rn, the correctly rounded reciprocal, the value of torch's and
// XLA's f32 1.0 / r), and v / r becomes __fmul_rn(v, 1 / r). The host picks the form per
// call.
//
// Bound on an H100: at batch 128 the (a)/(b) launches of stages 2-4 do 17-30 GOP each
// against 1,979 TOP/s of int8 tensor cores (operations); K4's calls move x8, the
// residual, out8 and y8 (32-128 MB) for ≈26 GOP (bytes at stage 2, about even at 4);
// (d) moves x8, q1 and sc8 (154 MB at RN50: 0.046 ms) for 3.3 GOP s8 and 13.2 GFLOP bf16.
//
// Design (Hopper: TMA, wgmma, mbarriers, warp specialisation; the building blocks are
// csrc/hopper.cuh, shared with K6/K7's bottleneck_bf16.cu). Both kernels run one
// 384-thread block per SM over a persistent tile walk. Warpgroup 2 is the producer: one
// thread keeps a ring of 128-k chunks (one 128-byte swizzle row of s8) in flight with
// TMA, signalled by full/empty mbarrier pairs; it drops to 40 registers (setmaxnreg).
// Warpgroups 0 and 1 are consumers (232 registers) and issue wgmma from shared memory.
// s8 wgmma has no transpose bit: both operands are K-major, so the weights come as an
// (N, K) copy built once with the operands (ops/quantize.py: `*_t`; the 3×3 kernel as
// (Cout, 9·Cin), k = (ky·3 + kx)·Cin + c, the order of the im2col walk). TMA's
// out-of-bounds zero fill covers ragged M, N and K (Cm = 16 pads 16 → 128 per chunk);
// TMA needs 16-byte row strides, so every C, Cm and N is a multiple of 16.
//   (a)/(b): 128 × BN output tiles (BN = 128; 64 for an s8 output with N ≤ 64), row
//   panels outer, each consumer warpgroup owning 64 rows. For (a), A is a 2-D tiled load
//   of the (M, K) rows; for (b), TMA's im2col mode over the NHWC input with the pixel
//   box at -1/-1, one load per (tap, 128-channel slice): the hardware walks 128 output
//   pixels across rows and images and zero-fills the halo. A launch with a residual has
//   the producer load each tile's 128 × 128 s8 residual ahead into a 4-slot ring. The
//   per-column S and b are loaded a tile ahead (lane l holds columns 2l, 2l + 1 and
//   64 + 2l, 65 + 2l) and shuffled to their threads in the epilogue. An s8 output of a
//   128-column tile is written into shared memory (in place of the residual where there
//   is one) and leaves with TMA stores in whole 128-byte rows; the bf16/f32 conv map and
//   64-column tiles are stored from registers.
//   (c): a tile is BM pixel rows. Phase 1 (cb3, Cm → C) streams x8 and the cb3 weights
//   through the ring, and its requant-with-residual epilogue writes out8 into a
//   resident tile T (BM × C s8) in the swizzled K-major layout that both wgmma's A
//   descriptor and a TMA store read. Then fence.proxy.async and a barrier of the
//   consumers; one thread stores T to out8 with TMA, and phase 2 (cb1, C → C1) reads
//   A = T from shared memory while its weights stream through the ring. Every tile reads
//   all of both weights from L2, so BM = 128 (each warpgroup 64 rows and all 128 columns
//   of a step) where T fits beside a two-stage ring and the tiles fill the SMs' waves
//   (RN50 stages 1-2), else 64 (both warpgroups share the m64 A operand and take 64
//   columns each). The ring depth is what T leaves: at BM = 128, 4 stages of 32 KB at
//   C ≤ 512; at BM = 64, stages of 24 KB: 6 at C ≤ 256, 5 at 512, 4 at 1024, 3 at 2048,
//   1 at RN50x16's 3072.
//   (d): as (a), one block per SM walks 128-row tiles of x8 (Cin ≤ 128: one chunk, zero
//   past Cin) through a 4-stage ring; cb1a's kernel (s8, K-major) and wsc (bf16, (Cin,
//   Cout), 64-column panels read N-major) stay resident. Each consumer warpgroup issues
//   cb1a's s8 wgmma from the tile, then converts its 64 rows to the shortcut's bf16 A
//   fragments in registers (bf16(float(x8)·s_in), the reference's op order) and issues
//   the shortcut's bf16 wgmma (A from registers) in passes of 128 columns; cb1a's
//   epilogue runs while the first pass's products do. Both outputs leave through
//   swizzled 64 × 128 staging slots (two per warpgroup) with TMA stores.
// Outputs are deterministic: no split-K, no atomics.
//
// What holds it back now (tools/bench_int8_gemm.py on NVIDIA H100 80GB HBM3 at 700 W):
// the epilogues' per-element arithmetic. K4's launches and the residual (a) run at
// 15-30% of their bound, and the (b) launches (K = 1152-4608 per output) reach 46-49% of
// the int8 peak. PERF.md §6 has the RECIP forms' times (chip_smoke.py phase 14 (a)).
// Measured and not kept: the
// requant as a product with the reciprocal plus one correction, the exact division
// deciding within 2^-14 of an integer (per thread: K5 1.657 against 1.442 ms an encode;
// as a warp-uniform branch: 1.909 against 1.458); 128-row (c) tiles at RN50 stage 3,
// whose 196 tiles leave a third of the SMs idle in the last wave (0.129 against 0.105 ms).
//
// Layouts: activations NHWC s8 flattened to (M = N·H·W, C) rows; per-column S and b f32;
// scales r_* device scalars; every pointer 16-byte aligned.

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 384;  // warpgroups 0, 1: consumers; 2: producer
constexpr int kBM = 128;       // (a)/(b) output rows per tile: 2 consumer warpgroups × 64
constexpr int kBK = 128;       // k per staged chunk: one 128-byte swizzle row of s8
constexpr int kSmemLimit = 232448;  // bytes of shared memory one H100 block may use
constexpr int kTooWide = kEncodeFailed - 1;  // K4: no tile of the block output fits
constexpr int kBadWidth = kEncodeFailed - 2;  // K3's entry: widths it does not take
constexpr int kBadForm = kEncodeFailed - 3;   // a requant form no launch takes

enum Out { kS8 = 0, kS8Res = 1, kBf16ResRelu = 2, kF32ResRelu = 3 };

// Shared memory of (a)/(b): the ring of A (128 × 128) and B (BN × 128) chunks; with a
// residual, four 128 × 128 residual slots (a launch with a residual has K ≤ 512: one to
// four chunks a tile), into which an s8 output is written in place; without, two
// 128 × 128 s8 output tiles (BN = 128); then the barriers and 1 KB of alignment slack.
template <int BN, bool RES>
struct GemmConfig {
  static constexpr int kStages = BN == 64 ? 8 : (RES ? 4 : 6);
  static constexpr int kResSlots = RES ? 4 : 0;
  static constexpr int kStaging = !RES && BN == 128 ? 2 : 0;  // s8 output tiles
  static constexpr int kStageBytes = (kBM + BN) * kBK;
  static constexpr int kResBytes = kBM * 128;
  static constexpr int kSmem = kStages * kStageBytes + (kResSlots + kStaging) * kResBytes +
                               8 * (2 * kStages + 2 * kResSlots) + 1024;
  static_assert(kSmem <= kSmemLimit, "more shared memory than an H100 block may have");
};

struct GemmParams {
  CUtensorMap a, b, res, out8;  // TMA descriptors (see ect_conv1x1_s8, ect_conv3x3_s8)
  const float* S;         // (N) per-column scale, in_scale · w_scale
  const float* bias;      // (N)
  const float* r_res;     // residual scale, or null
  const float* r_out;     // requant scale, or null for the bf16/f32 outputs
  void* out;              // (M, N): s8, bf16 or f32
  int chunks;             // 128-k chunks per tile
  int conv_c;             // (b): input channels (K = 9·conv_c); 0 for (a)
  int H, W;               // (b) geometry
  int M, N;
  int n_tiles, tiles;
};

// The epilogues are bound by the issue rate of their per-element arithmetic, where a
// type conversion or a reciprocal counts 8 times an add (16 a clock per SM, against 128
// adds). Two conversions are done exactly with adds instead: an s8 to float, and the
// truncation of a float in [0, 127].

// A requant scale as the epilogue uses it: r, or with RECIP its reciprocal.
template <bool RECIP>
__device__ __forceinline__ float requant_scale(const float* r) {
  return RECIP ? __frcp_rn(__ldg(r)) : __ldg(r);
}

// v / r, or with RECIP v · r for r the reciprocal (requant_scale).
template <bool RECIP>
__device__ __forceinline__ float unscale(float v, float r) {
  return RECIP ? __fmul_rn(v, r) : __fdiv_rn(v, r);
}

template <bool RECIP>
__device__ __forceinline__ int8_t requant_u8(float v, float r) {
  float y = __fadd_rn(unscale<RECIP>(v, r), 0.5f);
  y = fminf(fmaxf(y, 0.0f), 127.0f);
  // Truncating convert, y in [0, 127]: 2^23 + y rounded toward zero is 2^23 + trunc(y),
  // and its low mantissa bits are trunc(y).
  return (int8_t)(__float_as_int(__fadd_rz(y, 8388608.0f)) - 0x4B000000);
}

// The signed requant of a quotient v = x / r: v ± 0.5 by its sign, clip ±127, truncate.
__device__ __forceinline__ int8_t requant_quotient(float v) {
  v = v >= 0.0f ? __fadd_rn(v, 0.5f) : __fsub_rn(v, 0.5f);
  v = fminf(fmaxf(v, -127.0f), 127.0f);
  return (int8_t)(int)v;  // truncating convert, toward zero
}

__device__ __forceinline__ float affine(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
}

__device__ __forceinline__ uint16_t pack2(int8_t a, int8_t b) {
  return (uint16_t)((uint32_t)(uint8_t)a | ((uint32_t)(uint8_t)b << 8));
}

__device__ __forceinline__ uint32_t pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return (uint32_t)(uint8_t)a | ((uint32_t)(uint8_t)b << 8) |
         ((uint32_t)(uint8_t)c << 16) | ((uint32_t)(uint8_t)d << 24);
}

// Byte offset of (row r, column c < 128) in a tile of 128-byte rows with TMA's 128-byte
// swizzle: 16-byte chunk c / 16 of row r sits at chunk (c / 16) ^ (r % 8).
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

// d += A (64 × 32, K-major) · B (32 × n, K-major), s8 in, s32 out.
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
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
      : "l"(a), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_s8_n16(int (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(a), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_s8_n96(int (&d)[48], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(a), "l"(b), "n"(1));
}

// One 128-k chunk into acc: four k32 steps, each 32 bytes further along the swizzle rows
// of both operands (+2 in the descriptors' 16-byte address units); one commit group.
template <int BN>
__device__ __forceinline__ void mma_chunk(int (&acc)[BN / 2], uint64_t da, uint64_t db) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < kBK / 32; ++k) {
    if constexpr (BN == 128)
      wgmma_s8_n128(acc, da + 2 * k, db + 2 * k);
    else
      wgmma_s8_n64(acc, da + 2 * k, db + 2 * k);
  }
  wgmma_commit();
}

// float(q) of the s8 in byte 0 of u, exactly: 2^23 + (q + 128) has q + 128 (its bits
// q ^ 0x80) as its low mantissa bits, and subtracting 2^23 + 128 is exact.
__device__ __forceinline__ float s8_to_float(uint32_t u) {
  return __fsub_rn(__int_as_float(0x4B000000 | ((u ^ 0x80u) & 0xffu)), 8388736.0f);
}

// The epilogue's values of one column pair: float(acc)·S + b, plus float(res)·r_res with
// a residual (rp holds the two s8 residuals, low byte first).
template <bool RES>
__device__ __forceinline__ float2 epilogue_pair(int a0, int a1, float2 s, float2 b, uint32_t rp,
                                                float r_res) {
  float v0 = affine(a0, s.x, b.x), v1 = affine(a1, s.y, b.y);
  if (RES) {
    v0 = __fadd_rn(v0, __fmul_rn(s8_to_float(rp), r_res));
    v1 = __fadd_rn(v1, __fmul_rn(s8_to_float(rp >> 8), r_res));
  }
  return make_float2(v0, v1);
}

template <bool RECIP>
__device__ __forceinline__ uint16_t requant_pair(float2 v, float r) {
  return pack2(requant_u8<RECIP>(v.x, r), requant_u8<RECIP>(v.y, r));
}

// The S, b pair of the column pair 4j + lane % 4 of a 64-column group: lane l holds
// pair l (columns 2l, 2l + 1).
__device__ __forceinline__ float2 shfl_pair(float2 v, int j, int lane) {
  const int src = (4 * j + (lane & 3)) & 31;
  return make_float2(__shfl_sync(0xffffffffu, v.x, src), __shfl_sync(0xffffffffu, v.y, src));
}

__device__ __forceinline__ float2 load_pair(const float* p, int col, int n) {
  return col < n ? __ldg(reinterpret_cast<const float2*>(p + col)) : make_float2(0.0f, 0.0f);
}

// (a)/(b): out = epilogue(A · B) over 128 × BN tiles, A the pixel rows of x (CONV3 false:
// (M, K) s8) or the 3×3 im2col of an NHWC (M = n·H·W, C) s8 tensor (K = 9·C, zero halo),
// B the (N, K) K-major weights.
template <bool CONV3, int BN, int OUT, bool RECIP>
__global__ void __launch_bounds__(kThreads, 1) gemm_s8_kernel(const __grid_constant__ GemmParams p) {
  constexpr bool RES = OUT != kS8;
  // s8 outputs of 128-column tiles leave through shared memory and TMA stores (whole
  // 128-byte rows), in place in the residual slot or in an output tile; the rest are
  // stored from registers.
  constexpr bool STAGED = OUT == kS8Res || (OUT == kS8 && BN == 128);
  using Cfg = GemmConfig<BN, RES>;
  constexpr int S = Cfg::kStages, R = Cfg::kResSlots;
  static_assert(!RES || BN == 128, "a residual tile is 128 columns wide");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* a_ring = base;                    // S × 128 × 128
  uint8_t* b_ring = a_ring + S * kBM * kBK;  // S × BN × 128
  uint8_t* res_ring = b_ring + S * BN * kBK; // R × 128 × 128
  uint8_t* staging = res_ring + R * Cfg::kResBytes;  // kStaging × 128 × 128
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + Cfg::kStaging * Cfg::kResBytes);
  uint64_t* empty = full + S;
  uint64_t* res_full = empty + S;
  uint64_t* res_empty = res_full + R;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < R; ++s) {
      mbar_init(&res_full[s], 1);
      // in place: each warpgroup once its store has read the slot; else every thread
      mbar_init(&res_empty[s], OUT == kS8Res ? 2 : 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      const int per_tap = (p.conv_c + kBK - 1) / kBK;
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x, i = 0; tile < p.tiles; tile += gridDim.x, ++i) {
        const int m0 = (tile / p.n_tiles) * kBM, n0 = (tile % p.n_tiles) * BN;
        if constexpr (RES) {  // the tile's residual, a tile ahead of its epilogue
          const int rs = i % R;
          mbar_wait(&res_empty[rs], ((i / R) & 1) ^ 1);
          mbar_expect_tx(&res_full[rs], Cfg::kResBytes);
          tma_load_2d(res_ring + rs * Cfg::kResBytes, &p.res, &res_full[rs], n0, m0);
        }
        int img = 0, y0 = 0, x0 = 0;
        if (CONV3) {
          img = m0 / (p.H * p.W);
          const int rem = m0 - img * p.H * p.W;
          y0 = rem / p.W;
          x0 = rem - y0 * p.W;
        }
        for (int t = 0; t < p.chunks; ++t) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], Cfg::kStageBytes);
          uint8_t* as = a_ring + stage * kBM * kBK;
          int krow;
          if (CONV3) {
            const int tap = t / per_tap, c0 = (t - tap * per_tap) * kBK;
            tma_load_im2col(as, &p.a, &full[stage], c0, x0 - 1, y0 - 1, img,
                            static_cast<uint16_t>(tap % 3), static_cast<uint16_t>(tap / 3));
            krow = tap * p.conv_c + c0;  // k past this tap's C meets zero channels of A
          } else {
            krow = t * kBK;
            tma_load_2d(as, &p.a, &full[stage], krow, m0);
          }
          tma_load_2d(b_ring + stage * BN * kBK, &p.b, &full[stage], krow, n0);
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups 0 and 1: rows 64·wg … 64·wg + 63 of each tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid >> 7, lt = tid & 127, warp = lt >> 5, lane = lt & 31;
    const float r_out = p.r_out ? requant_scale<RECIP>(p.r_out) : 1.0f;
    const float r_res = p.r_res ? __ldg(p.r_res) : 0.0f;
    // Thread (warp, lane) holds, for each 8-column group j, columns 8j + 2·(lane%4) +
    // {0, 1} of tile rows rt and rt + 8.
    const int rt = 64 * wg + 16 * warp + (lane >> 2);
    int stage = 0, phase = 0;
    int acc[BN / 2];
    // The per-column S and b pairs of a tile, loaded a tile ahead.
    float2 sv[BN / 64], bv[BN / 64], s_next[BN / 64], b_next[BN / 64];
    auto load_sb = [&](int tile) {
      const int n0 = (tile % p.n_tiles) * BN;
#pragma unroll
      for (int h = 0; h < BN / 64; ++h) {
        s_next[h] = load_pair(p.S, n0 + 64 * h + 2 * lane, p.N);
        b_next[h] = load_pair(p.bias, n0 + 64 * h + 2 * lane, p.N);
      }
    };
    load_sb(blockIdx.x);

    for (int tile = blockIdx.x, i = 0; tile < p.tiles; tile += gridDim.x, ++i) {
      const int m0 = (tile / p.n_tiles) * kBM, n0 = (tile % p.n_tiles) * BN;
#pragma unroll
      for (int h = 0; h < BN / 64; ++h) {
        sv[h] = s_next[h];
        bv[h] = b_next[h];
      }
      if (tile + gridDim.x < p.tiles) load_sb(tile + gridDim.x);
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] = 0;

      int last = 0;
      for (int t = 0; t < p.chunks; ++t) {
        mbar_wait(&full[stage], phase);
        mma_chunk<BN>(acc, smem_desc(a_ring + stage * kBM * kBK + wg * 64 * kBK, 16, 1024),
                      smem_desc(b_ring + stage * BN * kBK, 16, 1024));
        wgmma_wait<1>();  // the chunk before this one is done: release its stage
        fence_regs(acc);
        if (t > 0 && lt == 0) mbar_arrive(&empty[last]);
        last = stage;
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lt == 0) mbar_arrive(&empty[last]);

      uint8_t* res_tile = res_ring + (RES ? (i % R) * Cfg::kResBytes : 0);
      uint8_t* out_tile = res_tile;  // where a staged s8 output goes
      if constexpr (RES) mbar_wait(&res_full[i % R], (i / R) & 1);
      if constexpr (OUT == kS8 && BN == 128) {
        out_tile = staging + (i & 1) * Cfg::kResBytes;
        // Tile i - 2's store has read this output tile.
        if (lt == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        named_sync(1 + wg);
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 s = shfl_pair(sv[j / 8], j, lane), b = shfl_pair(bv[j / 8], j, lane);
        const int c = 8 * j + 2 * (lane & 3);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = rt + 8 * half;
          const uint32_t rp =
              RES ? *reinterpret_cast<const uint16_t*>(res_tile + sw128(r, c)) : 0u;
          const float2 v = epilogue_pair<RES>(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1],
                                              s, b, rp, r_res);
          const int m = m0 + r, n = n0 + c;
          if constexpr (STAGED) {
            *reinterpret_cast<uint16_t*>(out_tile + sw128(r, c)) = requant_pair<RECIP>(v, r_out);
          } else if (m < p.M && n < p.N) {
            const size_t off = (size_t)m * p.N + n;
            if constexpr (OUT == kS8)
              *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(p.out) + off) =
                  requant_pair<RECIP>(v, r_out);
            else if constexpr (OUT == kBf16ResRelu)
              *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + off) =
                  __floats2bfloat162_rn(fmaxf(v.x, 0.0f), fmaxf(v.y, 0.0f));
            else
              *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) =
                  make_float2(fmaxf(v.x, 0.0f), fmaxf(v.y, 0.0f));
          }
        }
      }
      if constexpr (STAGED) {
        // Each warpgroup stores its 64 rows once all its threads have written them.
        fence_async_shared();
        named_sync(1 + wg);
        if (lt == 0) {
          tma_store_2d(&p.out8, out_tile + wg * 64 * 128, n0, m0 + 64 * wg);
          bulk_commit();
          if constexpr (OUT == kS8Res) {  // the slot is free once the store has read it
            asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
            mbar_arrive(&res_empty[i % R]);
          }
        }
      } else if constexpr (RES) {
        mbar_arrive(&res_empty[i % R]);
      }
    }
    if (STAGED && lt == 0) bulk_wait();
  }
}

// (c) K4's shared memory: T (BM × C s8, in chunks of 128 columns), the ring (each stage
// an x8 chunk, BM × 128, and a weight chunk, 128 columns × 128 k), the residual slots
// (BM × 128 each), the barriers; the ring depth is what T leaves. BM is 128 or 64 (the
// header, and ect_cb3_cb1_s8 for the choice).
constexpr int kCChunkB = 128 * kBK;  // 16 KB
// (ring stages, residual slots) in order of preference, by tile height: the first that
// fits beside T.
constexpr int kCRing128[][2] = {{4, 3}, {4, 2}, {3, 2}, {2, 2}};
constexpr int kCRing64[][2] = {{6, 8}, {5, 6}, {4, 4}, {3, 3}, {3, 2}, {2, 2}, {2, 1}, {1, 1}};

struct Cb3Cb1Params {
  CUtensorMap x8, k3, res, k1, out8;  // TMA descriptors (see ect_cb3_cb1_s8)
  const float* S3;
  const float* b3;
  const float* S1;
  const float* b1;
  const float* r_res;
  const float* r_out;
  const float* r_next;
  int8_t* y8;
  int M, C, C1;
  int chunks_cm, chunks_c;  // 128-k chunks of Cm and of C (= phase 1's column steps)
  int steps_c1;             // phase 2's 128-column steps
  int stages, res_slots;
  int tiles;
};

// (c) K4: out8 = requant(x8·k3·S3 + b3 + res8·r_res, r_out) and y8 = requant(out8·k1·S1 +
// b1, r_next) for BM-row tiles, out8 kept in shared memory between the two products.
// ONE_STAGE: the ring has one stage (C = 3072), so a chunk is released as soon as its
// products are done, not after the next chunk's are issued.
// RECIP: bit 0 takes out8's requant in the reciprocal form, bit 1 y8's.
template <int BM, bool ONE_STAGE, int RECIP>
__global__ void __launch_bounds__(kThreads, 1) cb3_cb1_kernel(const __grid_constant__ Cb3Cb1Params p) {
  constexpr bool SPLIT_N = BM == 64;      // the warpgroups split a step's columns
  constexpr int NB = SPLIT_N ? 64 : 128;  // columns of a step per warpgroup
  constexpr int kChunkA = BM * kBK, kStage = kChunkA + kCChunkB, kRes = BM * 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int S = p.stages, R = p.res_slots;
  uint8_t* T = base;
  uint8_t* ring = T + p.chunks_c * kChunkA;
  uint8_t* res_ring = ring + S * kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(res_ring + R * kRes);
  uint64_t* empty = full + S;
  uint64_t* res_full = empty + S;
  uint64_t* res_empty = res_full + R;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    for (int s = 0; s < R; ++s) {
      mbar_init(&res_full[s], 1);
      mbar_init(&res_empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer: phase 1's residual, x8 and cb3 chunks, then phase 2's cb1 chunks ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      int stage = 0, phase = 0, nres = 0;
      auto next = [&]() {
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      };
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int m0 = tile * BM;
        for (int nt = 0; nt < p.chunks_c; ++nt, ++nres) {
          const int rs = nres % R;
          mbar_wait(&res_empty[rs], ((nres / R) & 1) ^ 1);
          mbar_expect_tx(&res_full[rs], kRes);
          tma_load_2d(res_ring + rs * kRes, &p.res, &res_full[rs], nt * 128, m0);
          for (int kc = 0; kc < p.chunks_cm; ++kc, next()) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], kStage);
            uint8_t* st = ring + stage * kStage;
            tma_load_2d(st, &p.x8, &full[stage], kc * kBK, m0);
            tma_load_2d(st + kChunkA, &p.k3, &full[stage], kc * kBK, nt * 128);
          }
        }
        for (int nt = 0; nt < p.steps_c1; ++nt)
          for (int kc = 0; kc < p.chunks_c; ++kc, next()) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], kCChunkB);
            tma_load_2d(ring + stage * kStage + kChunkA, &p.k1, &full[stage], kc * kBK,
                        nt * 128);
          }
      }
    }
  } else {
    // ---- consumers: rows (a_row …) and columns (b_row …) of each step ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid >> 7, lt = tid & 127, warp = lt >> 5, lane = lt & 31;
    constexpr bool RECIP_OUT = RECIP & 1, RECIP_NEXT = RECIP & 2;
    const float r_res = __ldg(p.r_res), r_out = requant_scale<RECIP_OUT>(p.r_out),
                r_next = requant_scale<RECIP_NEXT>(p.r_next);
    const int a_row = SPLIT_N ? 0 : 64 * wg;  // this warpgroup's first row of the tile
    const int b_row = SPLIT_N ? 64 * wg : 0;  // its first column of a step
    const int rt = a_row + 16 * warp + (lane >> 2);  // rows rt and rt + 8 of the tile
    int stage = 0, phase = 0, nres = 0;
    int acc[NB / 2];

    // One 128-column step: acc = A · B over `chunks` chunks, A from the ring (a_t null)
    // or from T.
    auto mainloop = [&](int chunks, const uint8_t* a_t) {
#pragma unroll
      for (int j = 0; j < NB / 2; ++j) acc[j] = 0;
      int last = 0;
      for (int kc = 0; kc < chunks; ++kc) {
        mbar_wait(&full[stage], phase);
        const uint8_t* st = ring + stage * kStage;
        mma_chunk<NB>(acc, smem_desc((a_t ? a_t + kc * kChunkA : st) + a_row * kBK, 16, 1024),
                      smem_desc(st + kChunkA + b_row * kBK, 16, 1024));
        if constexpr (ONE_STAGE) {
          wgmma_wait<0>();
          fence_regs(acc);
          if (lt == 0) mbar_arrive(&empty[0]);
          phase ^= 1;
        } else {
          wgmma_wait<1>();
          fence_regs(acc);
          if (kc > 0 && lt == 0) mbar_arrive(&empty[last]);
          last = stage;
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      if constexpr (!ONE_STAGE) {
        wgmma_wait<0>();
        fence_regs(acc);
        if (lt == 0) mbar_arrive(&empty[last]);
      }
    };
    // The S, b pairs of step s of a tile (phase 1's steps, then phase 2's), each loaded
    // a step ahead: lane l holds columns b_row + 64h + 2l, + 1.
    const int n_steps = p.chunks_c + p.steps_c1;
    float2 sv[NB / 64], bv[NB / 64], s_next[NB / 64], b_next[NB / 64];
    auto load_sb = [&](int step) {
      const bool one = step < p.chunks_c;
      const int col = (one ? step : step - p.chunks_c) * 128 + b_row + 2 * lane;
#pragma unroll
      for (int h = 0; h < NB / 64; ++h) {
        s_next[h] = load_pair(one ? p.S3 : p.S1, col + 64 * h, one ? p.C : p.C1);
        b_next[h] = load_pair(one ? p.b3 : p.b1, col + 64 * h, one ? p.C : p.C1);
      }
    };
    auto take_sb = [&](int next_step) {
#pragma unroll
      for (int h = 0; h < NB / 64; ++h) {
        sv[h] = s_next[h];
        bv[h] = b_next[h];
      }
      load_sb(next_step);
    };
    load_sb(0);

    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = tile * BM;
      // Phase 1: cb3 + residual + requant → T, 128 columns of C per step.
      for (int nt = 0; nt < p.chunks_c; ++nt, ++nres) {
        take_sb(nt + 1);
        mainloop(p.chunks_cm, nullptr);
        const int rs = nres % R;
        mbar_wait(&res_full[rs], (nres / R) & 1);
        const uint8_t* res_tile = res_ring + rs * kRes;
        uint8_t* t_chunk = T + nt * kChunkA;
#pragma unroll
        for (int j = 0; j < NB / 8; ++j) {
          const float2 s = shfl_pair(sv[j / 8], j, lane), b = shfl_pair(bv[j / 8], j, lane);
          const int c = b_row + 8 * j + 2 * (lane & 3);  // column within the step
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = rt + 8 * half;
            const uint32_t rp = *reinterpret_cast<const uint16_t*>(res_tile + sw128(r, c));
            *reinterpret_cast<uint16_t*>(t_chunk + sw128(r, c)) = requant_pair<RECIP_OUT>(
                epilogue_pair<true>(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1], s, b, rp,
                                    r_res),
                r_out);
          }
        }
        mbar_arrive(&res_empty[rs]);
      }
      // T's generic stores are read next by the async proxy (the TMA store, wgmma).
      fence_async_shared();
      named_sync<256>(1);
      if (tid == 0) {
        for (int kc = 0; kc < p.chunks_c; ++kc)
          tma_store_2d(&p.out8, T + kc * kChunkA, kc * kBK, m0);
        bulk_commit();
      }
      // Phase 2: cb1 + requant from T → y8, 128 columns of C1 per step.
      for (int nt = 0; nt < p.steps_c1; ++nt) {
        take_sb((p.chunks_c + nt + 1) % n_steps);
        mainloop(p.chunks_c, T);
#pragma unroll
        for (int j = 0; j < NB / 8; ++j) {
          const float2 s = shfl_pair(sv[j / 8], j, lane), b = shfl_pair(bv[j / 8], j, lane);
          const int n = nt * 128 + b_row + 8 * j + 2 * (lane & 3);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = m0 + rt + 8 * half;
            if (m < p.M && n < p.C1)
              *reinterpret_cast<uint16_t*>(p.y8 + (size_t)m * p.C1 + n) = requant_pair<RECIP_NEXT>(
                  epilogue_pair<false>(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1], s, b,
                                       0u, 0.0f),
                  r_next);
          }
        }
      }
      // T is free once the out8 store has read it and both warpgroups' wgmmas are done.
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      named_sync<256>(1);
    }
    if (tid == 0) bulk_wait();
  }
}

// (d) K3's entry: the first 1×1 conv and the conv shortcut of stage 1's block 0 from one
// read of x8. Per 128-row tile (each consumer warpgroup 64 rows):
//   q1  = requant_u8(float(x8·k1a)·S1 + b1, r1)                  s8 wgmma, k1a_t resident
//   sc8 = requant_signed(bf16(float(x8)·s_in)·wsc + bsc, dsc)    bf16 wgmma, A from
//         registers (the s8 tile converted in the reference's op order), wsc (Cin, Cout)
//         resident and read N-major, in column passes of NP
// Both outputs go through per-warpgroup staging slots (64 × 128 s8, swizzled) and leave
// with TMA stores. CIN = CM ≤ 128: one x8 chunk a tile, zero-filled past CIN.
constexpr int kEntryStages = 4;
constexpr int kSlot = 64 * 128;  // a staging slot

struct EntryParams {
  CUtensorMap x8, k1, wsc, q1, sc;  // TMA descriptors (see ect_stage1_entry)
  const float* S1;
  const float* b1;
  const float* r1;
  const float* s_in;
  const float* bsc;
  const float* dsc;
  const int8_t* x8p;  // x8 (M, CIN) and sc8 (M, COUT) in device memory, for the exact sums
  int8_t* sc8p;
  uint64_t* ties;  // the flag words: [tile][pass][consumer thread]
  int M, tiles;
};

// m64nNk32 s8 wgmma for N = 16, 64, 96 (q1's widths), chosen by the accumulator's size.
__device__ __forceinline__ void wgmma_s8_n(int (&d)[8], uint64_t a, uint64_t b) {
  wgmma_s8_n16(d, a, b);
}
__device__ __forceinline__ void wgmma_s8_n(int (&d)[32], uint64_t a, uint64_t b) {
  wgmma_s8_n64(d, a, b);
}
__device__ __forceinline__ void wgmma_s8_n(int (&d)[48], uint64_t a, uint64_t b) {
  wgmma_s8_n96(d, a, b);
}

template <int R>
__device__ __forceinline__ void promote(float (&acc)[R], float (&d)[R]) {
  fence_regs(d);
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
}

// Two s8 (bytes 0, 1 of u) → bf16(float(x)·s) each, packed low k first: the A operand of
// the shortcut.
__device__ __forceinline__ uint32_t shortcut_pair(uint32_t u, float s) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(__fmul_rn(s8_to_float(u), s),
                                                 __fmul_rn(s8_to_float(u >> 8), s));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// sc8 must equal the plain version's on every element: a flipped shortcut step moves
// the block output, and through the later blocks' convs and residuals reaches 2 steps of
// K3's output. The plain version's sum is fl(E), the exact sum E of the bf16 products
// rounded once to f32. The tensor cores' sum acc differs from it by less than
// kTieMargin · S, S = Σ_k |x0·w|:
//  - A 32-k group is summed from zero on the tensor cores. Their arithmetic is taken to be
//    the model of Fasi, Higham, Mikaitis and Pranesh ("Numerical behavior of NVIDIA tensor
//    cores", PeerJ Comput. Sci. 7:e330, 2021): products exact; each addition of a block
//    of b products to the running sum aligns every addend to the largest exponent among
//    them and truncates it to at least 24 bits, and truncates the result to f32. Each
//    such addition then errs by less than (b + 1) · 2^-23 of the group's S_g, and the
//    group by less than (32 / b)(b + 1) · 2^-23 · S_g ≤ 2^-17 · S_g, for any b ≥ 1.
//  - The G - 1 IEEE promotion adds and the rounding of E each err by at most 2^-24 · S.
// So |acc - fl(E)| < (128 + G) · 2^-24 · S, and kTieMargin = 132 · 2^-24 covers CIN ≤ 128
// (G ≤ 4). S ≤ ||x0||₂ · ||w[:, c]||₂ (Cauchy-Schwarz), both norms rounded up. Where the
// quotient sc / dsc lies within that margin of a requant boundary (|q| + 0.5 an integer),
// the element's bit is set in its lane's flag word for the pass (no branch in the
// epilogue, whose divisions then overlap). Every word goes to device memory (`ties`, one
// per consumer thread, pass and tile: 1/8 of sc8's bytes), and a nonzero one is listed
// in its warpgroup's list in shared memory. The warpgroup flushes the list after its
// last tile, and before a tile whose words might not fit: once every TMA store it issued
// has landed, its threads share out the listed words, recompute each flagged element's
// sum exactly from x8 in device memory and the resident weights (f64 products and sum:
// exact at these widths) and rewrite the byte. (Fixed where flagged, inside the tile
// loop, the fix-ups kept every warp of a warpgroup waiting; fixed by the thread that
// flagged them, a warp ran one fix-up round for almost every word, with a few lanes busy.
// At RN50's widths, batch 128, on an H100, either cost more than the rest of the launch.)
// tests/test_torch_gpu.py plants near-ties at every entry width, enough of them to flush
// mid-launch, and holds sc8 bit-equal to the plain version.
constexpr float kTieMargin = 132.0f / 16777216.0f;
// Nonzero flag words a warpgroup's list holds: (tile iteration << 10 | pass << 8 | tid).
// A block runs fewer than 2^22 tile iterations: M < 2^31 rows over at least 5 blocks (an
// H100 runs 114-132).
constexpr int kTieCap = 4096;

// wsc[k, c] in the resident N-major panels (64 columns × CIN k-rows, 128-byte swizzled).
__device__ __forceinline__ float wsc_at(const uint8_t* wscs, int panel, int k, int c) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
      wscs + (c >> 6) * panel + k * 128 + (((((c & 63) >> 3) ^ k) & 7) << 4) + (c & 7) * 2));
}

// s + a² + b² for the two bf16 a, b of a fragment register (exact squares), rounded up.
__device__ __forceinline__ float add_squares(float s, uint32_t u) {
  const float a = __uint_as_float(u << 16), b = __uint_as_float(u & 0xFFFF0000u);
  return __fmaf_ru(b, b, __fmaf_ru(a, a, s));
}

// The quotient sc / dsc of the signed requant, and whether it lies within `margin` (plus
// the rounding of the add and the division) of a requant boundary.
__device__ __forceinline__ float quotient(float sc, float b, float dsc) {
  return __fdiv_rn(__fadd_rn(sc, b), dsc);
}

__device__ __forceinline__ bool near_tie(float v, float margin) {
  // |v| - 0.5 against its nearest integer (2^23 + y rounds y to an integer): exact adds,
  // at the rate of adds.
  const float av = fabsf(v), y = __fsub_rn(av, 0.5f);
  const float n = __fsub_rn(__fadd_rn(y, 8388608.0f), 8388608.0f);
  return fabsf(__fsub_rn(y, n)) <= margin + 4.8e-7f * av;
}

// The exact shortcut sum of x8 row xrow (CIN s8 in device memory, 16-byte aligned),
// column c, rounded once to f32; its requant. The row comes in 16-byte loads, all issued
// before the sum: one trip to memory per element.
template <int CIN>
__device__ __forceinline__ int8_t exact_shortcut_q(const int8_t* xrow, const uint8_t* wscs,
                                                   int c, float s_in, float b, float dsc) {
  int4 xv[CIN / 16];
#pragma unroll
  for (int j = 0; j < CIN / 16; ++j) xv[j] = __ldg(reinterpret_cast<const int4*>(xrow) + j);
  const int8_t* xs = reinterpret_cast<const int8_t*>(xv);
  double sum = 0.0;
#pragma unroll
  for (int k = 0; k < CIN; ++k) {
    const float x0 =
        __bfloat162float(__float2bfloat16_rn(__fmul_rn(static_cast<float>(xs[k]), s_in)));
    sum = fma(static_cast<double>(x0), static_cast<double>(wsc_at(wscs, CIN * 128, k, c)), sum);
  }
  return requant_quotient(quotient(__double2float_rn(sum), b, dsc));
}

template <int CIN, int COUT>
__global__ void __launch_bounds__(kThreads, 1) entry_kernel(const __grid_constant__ EntryParams p) {
  constexpr int CM = CIN;
  constexpr int NP = COUT > 64 ? 128 : 64;  // shortcut columns per pass
  constexpr int KS = (CIN + 31) / 32;       // s8 k32 steps of q1
  constexpr int CK = CIN / 16;              // bf16 k16 steps of the shortcut
  constexpr int G = (CK + 1) / 2;           // its 32-k groups
  constexpr int kTile = 128 * kBK;     // an x8 tile
  constexpr int kPanel = CIN * 128;    // a 64-column panel of wsc (CIN k-rows × 128 B)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ring = base;                            // kEntryStages × 128 × 128
  uint8_t* k1s = ring + kEntryStages * kTile;      // CM × 128 (K-major, zero past CIN)
  uint8_t* wscs = k1s + CM * 128;                  // Cout / 64 panels
  uint8_t* staging = wscs + (COUT / 64) * kPanel;  // 2 warpgroups × 2 slots
  float* colm = reinterpret_cast<float*>(staging + 4 * kSlot);  // COUT margin factors
  uint32_t* tie_refs = reinterpret_cast<uint32_t*>(colm + COUT);  // 2 × kTieCap
  int* tie_count = reinterpret_cast<int*>(tie_refs + 2 * kTieCap);  // one per warpgroup
  uint64_t* full = reinterpret_cast<uint64_t*>(tie_count + 2);
  uint64_t* empty = full + kEntryStages;
  uint64_t* wfull = empty + kEntryStages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kEntryStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread
    }
    mbar_init(wfull, 1);
    tie_count[0] = tie_count[1] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warpgroup: one thread loads the weights once, then the x8 tiles ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      mbar_expect_tx(wfull, CM * 128 + (COUT / 64) * kPanel);
      tma_load_2d(k1s, &p.k1, wfull, 0, 0);
      for (int q = 0; q < COUT / 64; ++q) tma_load_2d(wscs + q * kPanel, &p.wsc, wfull, 64 * q, 0);
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], kTile);
        tma_load_2d(ring + stage * kTile, &p.x8, &full[stage], 0, tile * 128);
        if (++stage == kEntryStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups 0 and 1: rows 64·wg … 64·wg + 63 of each tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = tid >> 7, lt = tid & 127, warp = lt >> 5, lane = lt & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rt = 16 * warp + g;  // rows rt and rt + 8 of this warpgroup's 64
  const float r1 = __ldg(p.r1), s_in = __ldg(p.s_in), dsc = __ldg(p.dsc);
  // q1's per-column S1, b1 pairs (lane l: columns 2l, 2l + 1 and 64 + 2l, 65 + 2l).
  float2 s1v[2], b1v[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s1v[h] = load_pair(p.S1, 64 * h + 2 * lane, CM);
    b1v[h] = load_pair(p.b1, 64 * h + 2 * lane, CM);
  }
  int acc1[CM / 2];
  float acc2[NP / 2], part[NP / 2];
  uint32_t a[CK][4];
  const uint64_t k1desc = smem_desc(k1s, 16, 1024);
  int stage = 0, phase = 0, nslot = 0;
  mbar_wait(wfull, 0);
  // Column c's factor of the tie margin: kTieMargin · ||wsc[:, c]||₂ / dsc, rounded up (in
  // units of the quotient sc / dsc, per unit of a row's ||x0||₂).
  for (int c = tid; c < COUT; c += 256) {
    float m = 0.0f;
    for (int k = 0; k < CIN; ++k) {
      const float w = wsc_at(wscs, kPanel, k, c);
      m = __fmaf_ru(w, w, m);
    }
    colm[c] = __fdiv_ru(__fmul_ru(kTieMargin, __fsqrt_ru(m)), dsc);
  }
  named_sync<256>(3);

  // Writes one 64 × 128 output block through this warpgroup's next staging slot and stores
  // it with TMA at (col0, row0); `write(slot)` fills the slot.
  auto stage_out = [&](const CUtensorMap* map, int col0, int row0, auto write) {
    uint8_t* slot = staging + (2 * wg + (nslot & 1)) * kSlot;
    // The store two blocks back has read this slot.
    if (lt == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    named_sync(1 + wg);
    write(slot);
    fence_async_shared();
    named_sync(1 + wg);
    if (lt == 0) {
      tma_store_2d(map, slot, col0, row0);
      bulk_commit();
    }
    ++nslot;
  };

  // Sums the flagged elements of this warpgroup's listed words again exactly and empties
  // the list, once every TMA store the warpgroup issued has landed.
  auto flush = [&]() {
    if (lt == 0) {
      bulk_wait();
      asm volatile("fence.proxy.async;\n" ::: "memory");
    }
    named_sync(1 + wg);
    const int listed = tie_count[wg];
    for (int j = lt; j < listed; j += 128) {
      const uint32_t ref = tie_refs[wg * kTieCap + j];
      const int tile = blockIdx.x + static_cast<int>(ref >> 10) * gridDim.x;
      const int pass = (ref >> 8) & 3, owner = ref & 255, olane = owner & 31;
      // The owner's rows and columns, as `rt` and `t` of that thread.
      const int orow = tile * 128 + 64 * wg + 16 * ((owner & 127) >> 5) + (olane >> 2);
      const int ocol = pass * NP + 2 * (olane & 3);
      uint64_t ties = p.ties[(static_cast<size_t>(tile) * (COUT / NP) + pass) * 256 + owner];
      while (ties) {
        const int i = __ffsll(static_cast<long long>(ties)) - 1;
        ties &= ties - 1;
        const int row = orow + 8 * ((i >> 1) & 1), c = ocol + 8 * (i >> 2) + (i & 1);
        if (row < p.M)
          p.sc8p[static_cast<size_t>(row) * COUT + c] = exact_shortcut_q<CIN>(
              p.x8p + static_cast<size_t>(row) * CIN, wscs, c, s_in, __ldg(p.bsc + c), dsc);
      }
    }
    named_sync(1 + wg);
    if (lt == 0) tie_count[wg] = 0;  // read by all only after stage_out's next barrier
  };

  int it = 0;  // this block's tile iteration
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
    // Room for this tile's words (every append of the last tile was made before the
    // last barrier of its stage_out, every one of this tile's after the next).
    if (tie_count[wg] > kTieCap - 128 * (COUT / NP)) flush();
    const int row0 = tile * 128 + 64 * wg;
    mbar_wait(&full[stage], phase);
    const uint8_t* xt = ring + stage * kTile;
    // q1: s8 products from shared memory.
#pragma unroll
    for (int i = 0; i < CM / 2; ++i) acc1[i] = 0;
    fence_regs(acc1);
    wgmma_fence();
    const uint64_t xdesc = smem_desc(xt + wg * 64 * kBK, 16, 1024);
#pragma unroll
    for (int k = 0; k < KS; ++k) wgmma_s8_n(acc1, xdesc + 2 * k, k1desc + 2 * k);
    wgmma_commit();
    // The shortcut's A fragments from the same tile: row rt + 8h, k 16s + 2t (+ 8) + {0, 1}
    // (16-byte chunk s of a 128-byte swizzled row sits at chunk s ^ (row % 8)).
#pragma unroll
    for (int s = 0; s < CK; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * wg + rt + 8 * h;
        const uint8_t* chunk = xt + r * 128 + (((s ^ r) & 7) << 4);
        a[s][h] = shortcut_pair(*reinterpret_cast<const uint16_t*>(chunk + 2 * t), s_in);
        a[s][2 + h] = shortcut_pair(*reinterpret_cast<const uint16_t*>(chunk + 8 + 2 * t), s_in);
      }
    // ||x0||₂ of rows rt and rt + 8, rounded up: this lane's k, then the quad's (lanes t).
    float srow[2] = {0.0f, 0.0f};
#pragma unroll
    for (int s = 0; s < CK; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        srow[h] = add_squares(add_squares(srow[h], a[s][h]), a[s][2 + h]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      srow[h] = __fadd_ru(srow[h], __shfl_xor_sync(0xffffffffu, srow[h], 1));
      srow[h] = __fsqrt_ru(__fadd_ru(srow[h], __shfl_xor_sync(0xffffffffu, srow[h], 2)));
    }
#pragma unroll 1  // one copy of the pass's long unrolled epilogue: the loop stays small
    for (int pass = 0; pass < COUT / NP; ++pass) {
      const int n0 = pass * NP;
      float2 bv[NP / 64];
#pragma unroll
      for (int h = 0; h < NP / 64; ++h) bv[h] = load_pair(p.bsc, n0 + 64 * h + 2 * lane, COUT);
      // The shortcut's products in 32-k groups (16 k at CIN 16), each summed on the tensor
      // cores in fresh registers and added to acc2 with IEEE adds in k order: the tensor
      // cores' truncating f32 sum over all of K biased sc8 past K3's contract.
      const uint64_t wdesc = smem_desc(wscs + (n0 / 64) * kPanel, kPanel, 1024);
      auto group = [&](float (&d)[NP / 2], int g) {
#pragma unroll
        for (int i = 0; i < NP / 2; ++i) d[i] = 0.0f;
        fence_regs(d);
        fence_regs(a[2 * g]);
        if (2 * g + 1 < CK) fence_regs(a[2 * g + 1]);
        wgmma_fence();
        wgmma_rs<NP, 1>(d, a[2 * g], wdesc + 256 * g);
        if (2 * g + 1 < CK) wgmma_rs<NP, 1>(d, a[2 * g + 1], wdesc + 256 * g + 128);
        wgmma_commit();
      };
      group(acc2, 0);
      if constexpr (G > 1) group(part, 1);
      if (pass == 0) {
        // q1's products are done (the shortcut's run on): write q1.
        wgmma_wait<(G > 1 ? 2 : 1)>();
        fence_regs(acc1);
        mbar_arrive(&empty[stage]);  // the tile's last reader is done with it
        stage_out(&p.q1, 0, row0, [&](uint8_t* slot) {
#pragma unroll
          for (int j = 0; j < CM / 8; ++j) {
            const float2 sc = shfl_pair(s1v[j / 8], j, lane), b = shfl_pair(b1v[j / 8], j, lane);
            const int c = 8 * j + 2 * t;
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<uint16_t*>(slot + sw128(rt + 8 * h, c)) = requant_pair<false>(
                  epilogue_pair<false>(acc1[4 * j + 2 * h], acc1[4 * j + 2 * h + 1], sc, b, 0u,
                                       0.0f),
                  r1);
          }
        });
      }
      wgmma_wait<0>();
      fence_regs(acc2);
#pragma unroll
      for (int g = 1; g < G; ++g) {
        if (g > 1) {
          group(part, g);
          wgmma_wait<0>();
        }
        promote(acc2, part);
      }
      stage_out(&p.sc, n0, row0, [&](uint8_t* slot) {
        uint64_t ties = 0;  // bit i: acc2[i] lies near a requant boundary
#pragma unroll
        for (int j = 0; j < NP / 8; ++j) {
          const float2 b = shfl_pair(bv[j / 8], j, lane);
          const int c = 8 * j + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h;
            const float v0 = quotient(acc2[i], b.x, dsc);
            const float v1 = quotient(acc2[i + 1], b.y, dsc);
            ties |= static_cast<uint64_t>(near_tie(v0, __fmul_ru(srow[h], colm[n0 + c]))) << i;
            ties |= static_cast<uint64_t>(near_tie(v1, __fmul_ru(srow[h], colm[n0 + c + 1])))
                    << (i + 1);
            *reinterpret_cast<uint16_t*>(slot + sw128(rt + 8 * h, c)) =
                pack2(requant_quotient(v0), requant_quotient(v1));
          }
        }
        p.ties[(static_cast<size_t>(tile) * (COUT / NP) + pass) * 256 + tid] = ties;
        if (ties)
          tie_refs[wg * kTieCap + atomicAdd(&tie_count[wg], 1)] =
              static_cast<uint32_t>(it) << 10 | pass << 8 | tid;
      });
    }
    if (++stage == kEntryStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  flush();
}

// ---------------------------------------------------------------- host side

// An (rows, cols) s8 matrix as box_cols × box_rows boxes (see encode_2d).
CUresult map_s8(CUtensorMap* map, const void* ptr, int rows, int cols, int box_cols,
                int box_rows) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, ptr, rows, cols, box_cols, box_rows);
}

template <bool CONV3, int BN, int OUT, bool RECIP = false>
cudaError_t launch_gemm(GemmParams& p, int device, int sms, cudaStream_t s) {
  static bool configured[kMaxDevices] = {};  // per instantiation and device
  constexpr int smem = GemmConfig<BN, OUT != kS8>::kSmem;
  if (!configured[device]) {
    cudaError_t err = cudaFuncSetAttribute(gemm_s8_kernel<CONV3, BN, OUT, RECIP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  p.n_tiles = (p.N + BN - 1) / BN;
  p.tiles = ((p.M + kBM - 1) / kBM) * p.n_tiles;
  const int grid = p.tiles < sms ? p.tiles : sms;
  gemm_s8_kernel<CONV3, BN, OUT, RECIP><<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

// Shared memory of K4's kernel at tile height bm with `stages` ring stages and `slots`
// residual slots.
size_t cb3_cb1_smem(int C, int bm, int stages, int slots) {
  return 1024 + (size_t)((C + kBK - 1) / kBK) * bm * kBK +
         (size_t)stages * (bm * kBK + kCChunkB) + (size_t)slots * bm * 128 +
         8 * (2 * stages + 2 * slots);
}

// The first (stages, slots) of `table` that fits at tile height bm; false if none does.
template <size_t N>
bool cb3_cb1_ring(const int (&table)[N][2], int C, int bm, int* stages, int* slots) {
  for (const auto& ring : table)
    if (cb3_cb1_smem(C, bm, ring[0], ring[1]) <= (size_t)kSmemLimit) {
      *stages = ring[0];
      *slots = ring[1];
      return true;
    }
  return false;
}

// K4's kernel for tile height bm and a ring of `stages`, in the requant form RECIP.
template <int RECIP>
auto cb3_cb1_pick(int bm, int stages) {
  return bm == 128 ? cb3_cb1_kernel<128, false, RECIP>
                   : stages > 1 ? cb3_cb1_kernel<64, false, RECIP> : cb3_cb1_kernel<64, true, RECIP>;
}

}  // namespace

// Plain C interface for ctypes. Each returns 0 on a clean launch, a cudaError_t code,
// kEncodeFailed + a CUresult when a tensor map is refused, or (ect_cb3_cb1_s8) kTooWide
// when C leaves no room in shared memory; ect_error_string names each. Scales named r_*
// are device pointers to one float. Weights w8t, k3t, k1t are the K-major (N, K) s8
// copies. `recip` selects the reciprocal requant where the TPU kernels take it (see the
// header); ect_error_string names kBadForm, the code of a form no launch takes.

// (a) 1×1 conv: out_kind 0 = s8 requant, 1 = s8 requant with residual,
// 2 = bf16 relu(v + residual), 3 = f32 relu(v + residual). recip 1 (only with out_kind
// 1, the last launch of K3 and of K5) takes the requant in the reciprocal form.
extern "C" int ect_conv1x1_s8(const void* x8, int M, int K, const void* w8t, int N,
                              const void* S, const void* b, const void* res,
                              const void* r_res, const void* r_out, void* out,
                              int out_kind, int recip, int device, void* stream) {
  if (recip && out_kind != kS8Res) return kBadForm;
  int sms = 0;
  cudaError_t err = prepare_launch(device, &sms);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0) return 0;
  if (out_kind < kS8 || out_kind > kF32ResRelu || (out_kind != kS8) != (res != nullptr))
    return (int)cudaErrorInvalidValue;
  const int bn = out_kind == kS8 && N <= 64 ? 64 : 128;
  GemmParams p{};
  CUresult r = map_s8(&p.a, x8, M, K, kBK, kBM);
  if (r == CUDA_SUCCESS) r = map_s8(&p.b, w8t, N, K, kBK, bn);
  if (r == CUDA_SUCCESS && res) r = map_s8(&p.res, res, M, N, 128, kBM);
  if (r == CUDA_SUCCESS && out_kind <= kS8Res && bn == 128)  // a staged s8 output
    r = map_s8(&p.out8, out, M, N, 128, 64);
  if (r != CUDA_SUCCESS) return kEncodeFailed + (int)r;
  p.S = static_cast<const float*>(S);
  p.bias = static_cast<const float*>(b);
  p.r_res = static_cast<const float*>(r_res);
  p.r_out = static_cast<const float*>(r_out);
  p.out = out;
  p.chunks = (K + kBK - 1) / kBK;
  p.M = M;
  p.N = N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case kS8:
      err = bn == 64 ? launch_gemm<false, 64, kS8>(p, device, sms, s)
                     : launch_gemm<false, 128, kS8>(p, device, sms, s);
      break;
    case kS8Res:
      err = recip ? launch_gemm<false, 128, kS8Res, true>(p, device, sms, s)
                  : launch_gemm<false, 128, kS8Res>(p, device, sms, s);
      break;
    case kBf16ResRelu:
      err = launch_gemm<false, 128, kBf16ResRelu>(p, device, sms, s);
      break;
    default: err = launch_gemm<false, 128, kF32ResRelu>(p, device, sms, s); break;
  }
  return (int)err;
}

// (b) 3×3 conv, stride 1, zero halo, s8 requant epilogue. x8 (n, H, W, C); w8t
// (N, 9·C).
extern "C" int ect_conv3x3_s8(const void* x8, int n, int H, int W, int C, const void* w8t,
                              int N, const void* S, const void* b, const void* r_out,
                              void* out8, int device, void* stream) {
  int sms = 0;
  cudaError_t err = prepare_launch(device, &sms);
  if (err != cudaSuccess) return (int)err;
  const int M = n * H * W;
  if (M <= 0) return 0;
  const int bn = N <= 64 ? 64 : 128;
  GemmParams p{};
  CUresult r = encode_3x3_im2col(&p.a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x8, n, H, W, C, kBK,
                                 kBM);
  if (r == CUDA_SUCCESS) r = map_s8(&p.b, w8t, N, 9 * C, kBK, bn);
  if (r == CUDA_SUCCESS && bn == 128) r = map_s8(&p.out8, out8, M, N, 128, 64);
  if (r != CUDA_SUCCESS) return kEncodeFailed + (int)r;
  p.S = static_cast<const float*>(S);
  p.bias = static_cast<const float*>(b);
  p.r_out = static_cast<const float*>(r_out);
  p.out = out8;
  p.chunks = 9 * ((C + kBK - 1) / kBK);
  p.conv_c = C;
  p.H = H;
  p.W = W;
  p.M = M;
  p.N = N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bn == 64 ? launch_gemm<true, 64, kS8>(p, device, sms, s)
                 : launch_gemm<true, 128, kS8>(p, device, sms, s);
  return (int)err;
}

// (c) K4: out8 (M, C) and y8 (M, C1) from x8 (M, Cm) and res8 (M, C). recip: bit 0 takes
// out8's requant in the reciprocal form, bit 1 y8's (K4 3, K3 1, K5 0).
extern "C" int ect_cb3_cb1_s8(const void* x8, const void* res8, int M, int Cm, int C,
                              int C1, const void* k3t, const void* S3, const void* b3,
                              const void* k1t, const void* S1, const void* b1,
                              const void* r_res, const void* r_out, const void* r_next,
                              void* out8, void* y8, int recip, int device, void* stream) {
  if (recip != 0 && recip != 1 && recip != 3) return kBadForm;
  int sms = 0;
  cudaError_t err = prepare_launch(device, &sms);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0) return 0;
  // 128-row tiles halve the weights' L2 traffic, where T fits beside a two-stage ring and
  // the tiles fill at least 90% of the SMs' last wave (RN50: stages 1 and 2; stage 3's
  // 196 tiles would leave a third of the SMs idle).
  const int tiles128 = (M + 127) / 128, waves = (tiles128 + sms - 1) / sms;
  int bm = 128, stages = 0, slots = 0;
  if (10 * tiles128 < 9 * waves * sms || !cb3_cb1_ring(kCRing128, C, bm, &stages, &slots)) {
    bm = 64;
    if (!cb3_cb1_ring(kCRing64, C, bm, &stages, &slots)) return kTooWide;
  }
  static bool configured[kMaxDevices] = {};
  if (!configured[device]) {
    for (auto kern : {cb3_cb1_kernel<128, false, 0>, cb3_cb1_kernel<64, false, 0>,
                      cb3_cb1_kernel<64, true, 0>, cb3_cb1_kernel<128, false, 1>,
                      cb3_cb1_kernel<64, false, 1>, cb3_cb1_kernel<64, true, 1>,
                      cb3_cb1_kernel<128, false, 3>, cb3_cb1_kernel<64, false, 3>,
                      cb3_cb1_kernel<64, true, 3>}) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
      if (err != cudaSuccess) return (int)err;
    }
    configured[device] = true;
  }
  Cb3Cb1Params p{};
  CUresult r = map_s8(&p.x8, x8, M, Cm, kBK, bm);
  if (r == CUDA_SUCCESS) r = map_s8(&p.k3, k3t, C, Cm, kBK, 128);
  if (r == CUDA_SUCCESS) r = map_s8(&p.res, res8, M, C, 128, bm);
  if (r == CUDA_SUCCESS) r = map_s8(&p.k1, k1t, C1, C, kBK, 128);
  if (r == CUDA_SUCCESS) r = map_s8(&p.out8, out8, M, C, 128, bm);
  if (r != CUDA_SUCCESS) return kEncodeFailed + (int)r;
  p.S3 = static_cast<const float*>(S3);
  p.b3 = static_cast<const float*>(b3);
  p.S1 = static_cast<const float*>(S1);
  p.b1 = static_cast<const float*>(b1);
  p.r_res = static_cast<const float*>(r_res);
  p.r_out = static_cast<const float*>(r_out);
  p.r_next = static_cast<const float*>(r_next);
  p.y8 = static_cast<int8_t*>(y8);
  p.M = M;
  p.C = C;
  p.C1 = C1;
  p.chunks_cm = (Cm + kBK - 1) / kBK;
  p.chunks_c = (C + kBK - 1) / kBK;
  p.steps_c1 = (C1 + 127) / 128;
  p.stages = stages;
  p.res_slots = slots;
  p.tiles = (M + bm - 1) / bm;
  const int grid = p.tiles < sms ? p.tiles : sms;
  const size_t smem = cb3_cb1_smem(C, bm, stages, slots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kern = recip == 3   ? cb3_cb1_pick<3>(bm, stages)
              : recip == 1 ? cb3_cb1_pick<1>(bm, stages)
                           : cb3_cb1_pick<0>(bm, stages);
  kern<<<grid, kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// (d) K3's entry: q1 (M, Cm) on r1 and sc8 (M, Cout) on dsc from x8 (M, Cin), with k1t
// the K-major (Cm, Cin) s8 cb1a kernel and wsc the (Cin, Cout) bf16 shortcut weights;
// (Cin = Cm, Cout) one of (16, 64), (64, 256), (96, 384); s_in the scale of x8. ties is
// scratch of ect_stage1_entry_ties(M, Cout) 8-byte words, read only by this launch.
extern "C" long long ect_stage1_entry_ties(int M, int Cout) {
  return (long long)((M + 127) / 128) * (Cout > 64 ? Cout / 128 : 1) * 256;
}

extern "C" int ect_stage1_entry(const void* x8, int M, int Cin, const void* k1t, int Cm,
                                const void* S1, const void* b1, const void* r1,
                                const void* wsc, int Cout, const void* s_in, const void* bsc,
                                const void* dsc, void* q1, void* sc8, void* ties, int device,
                                void* stream) {
  if (Cm != Cin || !((Cin == 16 && Cout == 64) || (Cin == 64 && Cout == 256) ||
                     (Cin == 96 && Cout == 384)))
    return kBadWidth;
  int sms = 0;
  cudaError_t err = prepare_launch(device, &sms);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0) return 0;
  EntryParams p{};
  CUresult r = map_s8(&p.x8, x8, M, Cin, kBK, 128);
  if (r == CUDA_SUCCESS) r = map_s8(&p.k1, k1t, Cm, Cin, kBK, Cm);
  if (r == CUDA_SUCCESS)
    r = encode_2d(&p.wsc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wsc, Cin, Cout, 64, Cin);
  if (r == CUDA_SUCCESS) r = map_s8(&p.q1, q1, M, Cm, 128, 64);
  if (r == CUDA_SUCCESS) r = map_s8(&p.sc, sc8, M, Cout, 128, 64);
  if (r != CUDA_SUCCESS) return kEncodeFailed + (int)r;
  p.S1 = static_cast<const float*>(S1);
  p.b1 = static_cast<const float*>(b1);
  p.r1 = static_cast<const float*>(r1);
  p.s_in = static_cast<const float*>(s_in);
  p.bsc = static_cast<const float*>(bsc);
  p.dsc = static_cast<const float*>(dsc);
  p.x8p = static_cast<const int8_t*>(x8);
  p.sc8p = static_cast<int8_t*>(sc8);
  p.ties = static_cast<uint64_t*>(ties);
  p.M = M;
  p.tiles = (M + 127) / 128;
  static bool configured[kMaxDevices] = {};
  if (!configured[device]) {
    for (auto kern : {entry_kernel<16, 64>, entry_kernel<64, 256>, entry_kernel<96, 384>}) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
      if (err != cudaSuccess) return (int)err;
    }
    configured[device] = true;
  }
  const size_t smem = 1024 + (size_t)kEntryStages * 128 * kBK + (size_t)Cm * 128 +
                      (size_t)(Cout / 64) * Cin * 128 + 4 * kSlot + 4 * (size_t)Cout +
                      4 * (2 * kTieCap + 2) + 8 * (2 * kEntryStages + 1);
  const int grid = p.tiles < sms ? p.tiles : sms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cin == 16)
    entry_kernel<16, 64><<<grid, kThreads, smem, s>>>(p);
  else if (Cin == 64)
    entry_kernel<64, 256><<<grid, kThreads, smem, s>>>(p);
  else
    entry_kernel<96, 384><<<grid, kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* ect_error_string(int code) {
  if (code >= kEncodeFailed) return "cuTensorMapEncode refused a tensor map (CUresult = code - 10000)";
  if (code == kTooWide)
    return "cb3-cb1: a 64-row tile of the block output (64 x C s8) leaves no room for a "
           "one-stage ring in shared memory; C is too wide";
  if (code == kBadWidth)
    return "stage-1 entry: (Cin = Cm, Cout) must be (16, 64), (64, 256) or (96, 384)";
  if (code == kBadForm)
    return "recip: the 1x1 launch takes 1 only with out_kind 1; cb3-cb1 takes 0, 1 or 3";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
