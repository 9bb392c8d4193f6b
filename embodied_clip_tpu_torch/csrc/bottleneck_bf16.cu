// Kernels K6 and K7: the bf16 stride-1 bottlenecks of the folded (serving) ResNet trunks;
// CLIP's anti-aliased stride-2 blocks on the same GEMM, with the 2×2 pool P.
//
// Replaces (embodied_clip_tpu/ops/pallas/bottleneck_kernel.py):
//   K6 fused_bottleneck  one stride-1 bottleneck, BN folded:
//                        h1 = bf16(relu(x·w1 + b1)); h2 = bf16(relu(conv3x3(h1, w2) + b2));
//                        out = bf16(relu(h2·w3 + b3 + x))
//   K7 fused_stage1      the whole stage 1: block 0 maps Cin → Cout with the 1×1 conv
//                        shortcut x·wsc + bsc added before the block relu; the identity
//                        blocks after it are K6's function
// The host wrappers (embodied_clip_tpu_torch/ops/kernels/bottleneck_kernel.py) run K6 as
// 3 launches of the one GEMM kernel below and K7 as 3 per block:
//   (a) 1×1 conv: A = the pixel rows of x (M = N·H·W, K = C), + bias, relu → bf16 h1
//   (b) 3×3 conv, stride 1, zero halo, as an implicit GEMM: K = 9·Cm, k = (ky·3+kx)·Cm + c
//       (the HWIO weight flattened), + bias, relu → bf16 h2
//   (c) 1×1 conv + bias + residual (bf16 x) + relu → bf16; for K7's block 0 the conv
//       shortcut is a second K loop over x·wsc into the same f32 sum, with bsc added
//       beside b3.
// h1/h2 (Cm = C/4 wide) go through device memory, mostly L2: a TPU core keeps a stage in
// VMEM, but one RN50 stage-1 image (1.6 MB in bf16) is far above an SM's 227 KB.
//
// CLIP's anti-aliased stride-2 blocks (block 0 of stages 2-4; no TPU kernel: the JAX
// package leaves them to XLA) take the same GEMM: (a) and (b) at the block's input
// resolution (CLIP's 3×3 runs at stride 1, before the pool), then P, the one launch here
// that is not a GEMM, pools h2 and the block input x, then (c) is K7's block-0 form:
// out = bf16(relu(p·w3 + xp·wds + b3 + bds)) with the pooled shortcut as the second K
// loop. P (avg_pool2_pair_bf16_kernel) is bound by bytes: at batch 128 it moves
// 385 / 193 / 96 MB in stages 2 / 3 / 4 (0.115 / 0.058 / 0.029 ms at 3.35 TB/s).
//
// Bound on an H100 at batch 128 (RN50 shapes; 3.35 TB/s, 989 TFLOP/s dense bf16): a
// stage-3 or stage-4 K6 call does ≈5.6e10 operations (≈0.0565 ms, operations); a stage-2
// call moves ≈0.2 GB of x, weights and output (≈0.061 ms, bytes); K7 does 1.71e11
// operations (≈0.173 ms), but its three launches per block also move h1/h2 (51 MB each at
// 56×56) through device memory, ≈2.1 GB in all, a floor near 0.64 ms. The mma.sync kernel
// this one replaced (128 × 64 tiles of 8 warps with 32 × 32 warp tiles, a 3-deep cp.async
// ring) was held by the issue rate of ldmatrix + mma.sync: ≈124 TFLOP/s at stage 4.
//
// Design (Hopper: TMA, wgmma, mbarriers, warp specialisation; the building blocks are
// csrc/hopper.cuh, shared with K3-K5's bottleneck_int8.cu). A persistent grid of one
// 384-thread block per SM walks 128 × BN output tiles (BN = 128; 64 when N ≤ 64), row
// panels outer and column panels inner, so the blocks running at once share one A panel
// and the weights (≤4.7 MB) stay in L2. Warpgroup 2 is the producer: one thread keeps a
// ring of 64-k chunks in flight with TMA (cp.async.bulk.tensor), 128-byte swizzled,
// signalled by full/empty mbarrier pairs; it drops to 40 registers (setmaxnreg). For (a)
// and (c), A is a 2-D tiled load of the (M, K) rows; for (b) it is TMA's im2col mode over
// the NHWC h1 with the pixel box at -1 on both sides ('SAME'), one load per (tap,
// 64-channel slice): the hardware walks 128 output pixels across rows and images and
// zero-fills the halo, so no thread computes a gather address and no proxy fence is
// needed (a cp.async gather by a producer warpgroup was the alternative). The weights stay
// (K, N) row-major as the JAX package keeps them: B is loaded as 64-column panels and read
// by wgmma as an N-major operand (transpose bit set). Out-of-bounds zero fill covers
// ragged M, N and K (Cm = 8 pads 8 → 64 per chunk). Warpgroups 0 and 1 are consumers (232
// registers): each owns 64 rows of the tile and issues wgmma.mma_async m64nBNk16 from
// shared memory. The tensor cores' f32 accumulation truncates: with one accumulator
// through the whole K loop its bias flipped bf16 roundings of h1/h2 on up to 5% of
// outputs against the plain version. So each 32-k group (two k16 wgmmas) is summed in
// fresh registers and added to the running f32 sum with IEEE adds, in k order; a chunk's
// two groups go to two register sets, and the first group's adds run while the tensor
// cores work on the second. The epilogue adds f32 bias (+ bias2) (+ the bf16 residual),
// applies relu and rounds once with __float2bfloat16_rn, in place in a swizzled staging
// tile that TMA then stores; the store of one tile drains under the next tile's main
// loop. The bias pairs are loaded when a tile starts (lane l holds columns 2l and
// 64 + 2l) and shuffled to their threads in the epilogue; the producer loads a tile's
// residual a tile ahead into a 3-deep staging ring. Outputs are deterministic: no
// split-K, no atomics.
//
// Measured and not kept (tools/bench_bf16_gemm.py --source, this file differing: the 39
// launches of a batch-128 clip_rn50 encode summed, NVIDIA H100 80GB HBM3 at 700 W,
// compared within one run):
// 32-k groups pipelined across chunks (the next chunk's group in flight while the last
// one's adds run) made ptxas serialise every wgmma (C7514): 3.27 ms against 3.10 ms for
// two groups per chunk; one register set with wgmma.wait_group 0 before each add: 3.15 ms;
// adding every 64 k: 5% faster, but 1.22% of an RN50x16 stage-4 output differed (limit
// 1%); every 128 k: 4% faster again, and 0.99% on an imagenet_rn50 call; two
// chunks per loop turn, so that only one add in two runs with no wgmma in flight:
// 2.970 / 2.935 ms against 2.965 / 2.954 (no gain); BN = 64 wherever it fills the SMs'
// waves better (stage 4): 0.0884 against 0.0826 ms for stage 4's (b); the bias read in
// the epilogue, behind a bounds check: 2.98 against 2.745 ms; the two consumer
// warpgroups taking turns at the epilogue (named barriers), to stagger them: 2.805 /
// 2.815 against 2.709 / 2.709 ms. Builds that break the
// contract show what holds the kernel back now: without the IEEE adds the launches take
// 14% less time; with an epilogue that only sums the tile, 3% less. Stage 1's (b), whose
// im2col loads read every h1 pixel nine times from L2, runs at 29% of the bf16 peak.
//
// Layouts: activations NHWC bf16 flattened to (M, C) rows; weights (K, N) bf16 row-major;
// biases f32. C, Cm and N multiples of 8; every pointer 16-byte aligned.

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;         // output rows (pixels) per tile: 2 consumer warpgroups × 64
constexpr int kBK = 64;          // k per staged chunk: one 128-byte swizzle row of bf16
// k summed on the tensor cores before each IEEE add into the running f32 sum (two
// groups per chunk; 64 put RN50x16's stage 4 past the 1% contract).
constexpr int kGroupK = 32;
static_assert(kBK == 2 * kGroupK, "the main loop issues two groups per chunk");
constexpr int kThreads = 384;    // warpgroups 0, 1: consumers; 2: producer
constexpr int kPanel = 64 * 64;  // bf16 per 64 × 64 swizzled panel (8 KB)

// Shared memory: the ring of A and B chunks, and the output staging tiles (128 × BN
// each; warpgroup w stores rows 64w … 64w + 63). A launch with a residual keeps three
// staging tiles, so the producer can load tile i + 1's residual into one while tile i's
// epilogue reads another and tile i - 1's store drains the third; one ring stage pays
// for it.
template <int BN, bool RES>
struct Config {
  static constexpr int kStaging = RES ? 3 : 2;
  static constexpr int kStages = (BN == 64 ? 8 : 5) - (RES ? 1 : 0);
  static constexpr int kStageBytes = (kBM + BN) * kBK * 2;
  static constexpr int kStagingBytes = kBM * BN * 2;
  // ring, staging tiles, barriers, 1 KB of alignment slack
  static constexpr int kSmem = kStages * kStageBytes + kStaging * kStagingBytes + 256 + 1024;
  static_assert(kSmem <= 232448, "more shared memory than an H100 block may have");
};

struct Params {
  CUtensorMap a, b, a2, b2, res, out;  // TMA descriptors (see ect_gemm_bf16)
  const float* bias;
  const float* bias2;  // or null
  int chunks1;         // 64-k chunks of the first product
  int chunks2;         // of the second (K7's shortcut), or 0
  int conv_c;          // conv3: channels (K = 9·conv_c); 0 for a 1×1 product
  int H, W;            // conv3 geometry
  int N;
  int n_tiles, tiles;
};

// out = bf16(relu(A·B [+ A2·B2] + bias [+ bias2] [+ res])) over 128 × BN tiles; RES: with
// the residual res.
template <bool CONV3, bool RES, int BN>
__global__ void __launch_bounds__(kThreads, 1) gemm_bf16_kernel(const __grid_constant__ Params p) {
  using Cfg = Config<BN, RES>;
  constexpr int S = Cfg::kStages, T = Cfg::kStaging;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __nv_bfloat16* a_ring = reinterpret_cast<__nv_bfloat16*>(base);  // S × 128 × 64
  __nv_bfloat16* b_ring = a_ring + S * kBM * kBK;                   // S × 64 × BN
  __nv_bfloat16* staging = b_ring + S * kBK * BN;                   // T × 128 × BN
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + T * kBM * BN);
  uint64_t* empty = full + S;
  uint64_t* res_full = empty + S;
  uint64_t* res_empty = res_full + T;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < T; ++s) {
      mbar_init(&res_full[s], 1);
      mbar_init(&res_empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int chunks = p.chunks1 + p.chunks2;
  const int per_tap = (p.conv_c + kBK - 1) / kBK;
  if (tid >= 256) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x, i = 0; tile < p.tiles; tile += gridDim.x, ++i) {
        const int m0 = (tile / p.n_tiles) * kBM, n0 = (tile % p.n_tiles) * BN;
        if (RES) {  // the residual tile, into the staging tile this tile's epilogue uses
          const int sb = i % T;
          mbar_wait(&res_empty[sb], ((i / T) & 1) ^ 1);
          mbar_expect_tx(&res_full[sb], Cfg::kStagingBytes);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int q = 0; q < BN / 64; ++q)
              tma_load_2d(staging + (sb * 2 + h) * 64 * BN + q * kPanel, &p.res, &res_full[sb],
                          n0 + 64 * q, m0 + 64 * h);
        }
        int img = 0, y0 = 0, x0 = 0;
        if (CONV3) {
          img = m0 / (p.H * p.W);
          const int rem = m0 - img * p.H * p.W;
          y0 = rem / p.W;
          x0 = rem - y0 * p.W;
        }
        for (int t = 0; t < chunks; ++t) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], Cfg::kStageBytes);
          __nv_bfloat16* as = a_ring + stage * kBM * kBK;
          __nv_bfloat16* bs = b_ring + stage * kBK * BN;
          const CUtensorMap* bmap = &p.b;
          int krow;
          if (t >= p.chunks1) {  // K7's shortcut: x · wsc
            krow = (t - p.chunks1) * kBK;
            tma_load_2d(as, &p.a2, &full[stage], krow, m0);
            bmap = &p.b2;
          } else if (CONV3) {
            const int tap = t / per_tap, c0 = (t - tap * per_tap) * kBK;
            tma_load_im2col(as, &p.a, &full[stage], c0, x0 - 1, y0 - 1, img,
                            static_cast<uint16_t>(tap % 3), static_cast<uint16_t>(tap / 3));
            krow = tap * p.conv_c + c0;  // rows past this tap's C meet zero channels of A
          } else {
            krow = t * kBK;
            tma_load_2d(as, &p.a, &full[stage], krow, m0);
          }
#pragma unroll
          for (int q = 0; q < BN / 64; ++q)
            tma_load_2d(bs + q * kPanel, bmap, &full[stage], n0 + 64 * q, krow);
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
    int stage = 0, phase = 0;
    float acc[BN / 2], part0[BN / 2], part1[BN / 2];

    for (int tile = blockIdx.x, i = 0; tile < p.tiles; tile += gridDim.x, ++i) {
      const int m0 = (tile / p.n_tiles) * kBM, n0 = (tile % p.n_tiles) * BN;
      const int sb = i % T;
      __nv_bfloat16* out_tile = staging + (sb * 2 + wg) * 64 * BN;
      if (RES && lt == 0) {
        // Tile i - 2's store has read its staging tile: tile i + 1's residual may land there.
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        if (i + 1 >= T) mbar_arrive(&res_empty[(i + 1) % T]);
      }
      // The tile's bias (and bias2), loaded now and landing during the main loop: lane l
      // holds the pairs at columns 2l and 64 + 2l; the epilogue shuffles them out.
      float2 bias[BN / 64], bias2[BN / 64];
#pragma unroll
      for (int h = 0; h < BN / 64; ++h) {
        const int col = n0 + 64 * h + 2 * lane;
        const bool in = col < p.N;
        bias[h] = in ? __ldg(reinterpret_cast<const float2*>(p.bias + col)) : make_float2(0, 0);
        bias2[h] = in && p.bias2 ? __ldg(reinterpret_cast<const float2*>(p.bias2 + col))
                                 : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] = 0.0f;

      // Each 32-k group of a chunk is summed on the tensor cores in its own fresh
      // registers, then added to acc with IEEE adds, in k order; the first group's adds
      // run while the tensor cores work on the second.
      for (int t = 0; t < chunks; ++t) {
        mbar_wait(&full[stage], phase);
        const uint64_t da = smem_desc(a_ring + stage * kBM * kBK + wg * 64 * kBK, 16, 1024);
        const uint64_t db = smem_desc(b_ring + stage * kBK * BN, kPanel * 2, 1024);
        wgmma_group<BN>(part0, da, db, 0);
        wgmma_group<BN>(part1, da, db, 1);
        wgmma_wait<1>();
        promote(acc, part0);
        wgmma_wait<0>();
        if (lt == 0) mbar_arrive(&empty[stage]);
        promote(acc, part1);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }

      // Epilogue: thread (warp, lane) holds, for each 8-column group j, columns
      // 8j + 2·(lane%4) + {0, 1} of rows 16·warp + lane/4 (+ 8).
      if (RES) {
        mbar_wait(&res_full[sb], (i / T) & 1);
      } else {
        // Tile i - 2's store has read this staging tile.
        if (lt == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        named_sync(1 + wg);
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        // Column pair 4j + lane%4 of the tile: lane (4j + lane%4) % 32, register j / 8.
        const int src = (4 * j + (lane & 3)) & 31;
        const float2 b = make_float2(__shfl_sync(0xffffffffu, bias[j / 8].x, src),
                                     __shfl_sync(0xffffffffu, bias[j / 8].y, src));
        float2 b2 = make_float2(0.0f, 0.0f);
        if (p.bias2)
          b2 = make_float2(__shfl_sync(0xffffffffu, bias2[j / 8].x, src),
                           __shfl_sync(0xffffffffu, bias2[j / 8].y, src));
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * warp + (lane >> 2) + 8 * half;
          // 128-byte swizzle: 16-byte chunk c of row r sits at chunk c ^ (r % 8).
          __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
              out_tile + (j >> 3) * kPanel + r * 64 + (((j & 7) ^ (r & 7)) << 3) + 2 * (lane & 3));
          float v0 = acc[4 * j + 2 * half] + b.x;
          float v1 = acc[4 * j + 2 * half + 1] + b.y;
          if (p.bias2) {
            v0 += b2.x;
            v1 += b2.y;
          }
          if (RES) {
            const float2 rv = __bfloat1622float2(*dst);
            v0 += rv.x;
            v1 += rv.y;
          }
          *dst = __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
        }
      }
      fence_async_shared();
      named_sync(1 + wg);
      if (lt == 0) {
#pragma unroll
        for (int q = 0; q < BN / 64; ++q)
          tma_store_2d(&p.out, out_tile + q * kPanel, n0 + 64 * q, m0 + 64 * wg);
        bulk_commit();
      }
    }
    if (lt == 0) bulk_wait();
  }
}

// P: the 2×2 average pools of a CLIP stride block's h2 and of its input x in one launch,
// each an NHWC bf16 tensor (n, H, W, C) with C a multiple of 8 → (n, H/2, W/2, C), floor
// division where H or W is odd (the last row or column is not read), as avg_pool2d does.
// The arithmetic is avg_pool2d's on bf16: the window summed in f32 from +0 in row-major
// order, divided by 4 (×0.25 is the same correctly rounded quotient) and rounded once to
// bf16, so the two are bit-equal, signed zeros included. Each thread turns four 16-byte
// loads (8 channels of the window's pixels) into one 16-byte store; the flat index runs
// over h2's outputs and then x's, so one grid-stride loop balances both.
__device__ __forceinline__ uint32_t avg4_bf16x2(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
  const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
  const float2 fc = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&c));
  const float2 fd = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&d));
  const float x = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(0.0f, fa.x), fb.x), fc.x), fd.x);
  const float y = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(0.0f, fa.y), fb.y), fc.y), fd.y);
  const __nv_bfloat162 r = __floats2bfloat162_rn(__fmul_rn(x, 0.25f), __fmul_rn(y, 0.25f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__global__ void avg_pool2_pair_bf16_kernel(const uint4* __restrict__ a, uint4* __restrict__ pa,
                                           int a8, const uint4* __restrict__ b,
                                           uint4* __restrict__ pb, int b8, int H, int W,
                                           long long total_a, long long total) {
  const int H2 = H / 2, W2 = W / 2;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const bool second = i >= total_a;
    const long long j = second ? i - total_a : i;
    const int c8 = second ? b8 : a8;  // 16-byte groups of channels per pixel
    const uint4* x = second ? b : a;
    const int cg = static_cast<int>(j % c8);
    const long long pix = j / c8;
    const int ox = static_cast<int>(pix % W2);
    const long long r = pix / W2;
    const int oy = static_cast<int>(r % H2);
    const long long img = r / H2;
    const uint4* p = x + ((img * H + 2 * oy) * W + 2 * ox) * c8 + cg;
    const size_t row = static_cast<size_t>(W) * c8;
    const uint4 v00 = __ldg(p), v01 = __ldg(p + c8), v10 = __ldg(p + row),
                v11 = __ldg(p + row + c8);
    uint4 o;
    o.x = avg4_bf16x2(v00.x, v01.x, v10.x, v11.x);
    o.y = avg4_bf16x2(v00.y, v01.y, v10.y, v11.y);
    o.z = avg4_bf16x2(v00.z, v01.z, v10.z, v11.z);
    o.w = avg4_bf16x2(v00.w, v01.w, v10.w, v11.w);
    (second ? pb : pa)[j] = o;
  }
}

// ---------------------------------------------------------------- host side

// A row-major (rows, cols) bf16 matrix, loaded or stored as 64 × box_rows boxes, 128-byte
// swizzled; out-of-bounds elements read as zero and are not written.
CUresult map_2d(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, rows, cols, 64, box_rows);
}

// NHWC (n, H, W, C) bf16 in im2col mode for the 3×3 'SAME' convolution: 128 pixels × 64
// channels per load (see encode_3x3_im2col).
CUresult map_im2col(CUtensorMap* map, const void* ptr, int n, int H, int W, int C) {
  return encode_3x3_im2col(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, n, H, W, C, 64, kBM);
}

template <bool CONV3, bool RES, int BN>
cudaError_t launch(Params& p, int M, int device, int sms, cudaStream_t s) {
  static bool configured[kMaxDevices] = {};  // per instantiation and device
  constexpr int smem = Config<BN, RES>::kSmem;
  if (!configured[device]) {
    cudaError_t err = cudaFuncSetAttribute(gemm_bf16_kernel<CONV3, RES, BN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  p.n_tiles = (p.N + BN - 1) / BN;
  p.tiles = ((M + kBM - 1) / kBM) * p.n_tiles;
  const int grid = p.tiles < sms ? p.tiles : sms;
  gemm_bf16_kernel<CONV3, RES, BN><<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_kind(Params& p, int M, int device, int sms, cudaStream_t s, bool conv3,
                        bool res) {
  if (conv3) return launch<true, false, BN>(p, M, device, sms, s);
  return res ? launch<false, true, BN>(p, M, device, sms, s)
             : launch<false, false, BN>(p, M, device, sms, s);
}

}  // namespace

// Plain C interface for ctypes. Returns 0 on a clean launch, a cudaError_t code, or
// kEncodeFailed + a CUresult when a tensor map is refused (ect_error_string names both).
// One fused GEMM: out (M, N) = bf16(relu(A·B [+ a2·b2] + bias [+ bias2] [+ res])).
// conv3_c > 0: A is NHWC (M = n·H·W pixels, conv3_c channels) and the product is the
// 3×3 'SAME' convolution with B the HWIO kernel flattened to (9·conv3_c, N).
extern "C" int ect_gemm_bf16(const void* a, int M, int K, const void* b, int N,
                             const void* bias, const void* a2, int K2, const void* b2,
                             const void* bias2, const void* res, void* out, int conv3_c,
                             int H, int W, int device, void* stream) {
  int sms = 0;
  cudaError_t err = prepare_launch(device, &sms);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0) return 0;

  Params p{};
  CUresult r = CUDA_SUCCESS;
  if (conv3_c > 0) {
    r = map_im2col(&p.a, a, M / (H * W), H, W, conv3_c);
    p.chunks1 = 9 * ((conv3_c + kBK - 1) / kBK);
  } else {
    r = map_2d(&p.a, a, M, K, kBM);
    p.chunks1 = (K + kBK - 1) / kBK;
  }
  const int Kb = conv3_c > 0 ? 9 * conv3_c : K;
  if (r == CUDA_SUCCESS) r = map_2d(&p.b, b, Kb, N, kBK);
  if (r == CUDA_SUCCESS && a2) {
    r = map_2d(&p.a2, a2, M, K2, kBM);
    if (r == CUDA_SUCCESS) r = map_2d(&p.b2, b2, K2, N, kBK);
    p.chunks2 = (K2 + kBK - 1) / kBK;
  }
  if (r == CUDA_SUCCESS && res) r = map_2d(&p.res, res, M, N, 64);
  if (r == CUDA_SUCCESS) r = map_2d(&p.out, out, M, N, 64);
  if (r != CUDA_SUCCESS) return kEncodeFailed + (int)r;
  p.bias = static_cast<const float*>(bias);
  p.bias2 = static_cast<const float*>(bias2);
  p.conv_c = conv3_c;
  p.H = H;
  p.W = W;
  p.N = N;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool conv3 = conv3_c > 0, with_res = res != nullptr;
  if (conv3 && with_res) return (int)cudaErrorInvalidValue;
  err = N <= 64 ? launch_kind<64>(p, M, device, sms, s, conv3, with_res)
                : launch_kind<128>(p, M, device, sms, s, conv3, with_res);
  return (int)err;
}

// P: pa (n, H/2, W/2, Ca) and pb (n, H/2, W/2, Cb) = the 2×2 average pools of the NHWC
// bf16 tensors a (n, H, W, Ca) and b (n, H, W, Cb); Ca and Cb multiples of 8, every pointer
// 16-byte aligned; odd H or W drop the last row or column.
extern "C" int ect_avg_pool2_pair_bf16(const void* a, int Ca, const void* b, int Cb, int n,
                                       int H, int W, void* pa, void* pb, int device,
                                       void* stream) {
  if (Ca <= 0 || Cb <= 0 || Ca % 8 || Cb % 8 || n < 0 || H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = prepare_launch(device, &sms);
  if (err != cudaSuccess) return (int)err;
  const long long pixels = (long long)n * (H / 2) * (W / 2);
  const long long total_a = pixels * (Ca / 8), total = total_a + pixels * (Cb / 8);
  if (total <= 0) return 0;
  const long long blocks = (total + 255) / 256;
  const int grid = static_cast<int>(blocks < 16LL * sms ? blocks : 16LL * sms);
  avg_pool2_pair_bf16_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a), static_cast<uint4*>(pa), Ca / 8,
      static_cast<const uint4*>(b), static_cast<uint4*>(pb), Cb / 8, H, W, total_a, total);
  return (int)cudaGetLastError();
}

extern "C" const char* ect_error_string(int code) {
  if (code >= kEncodeFailed) return "cuTensorMapEncode refused a tensor map (CUresult = code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
