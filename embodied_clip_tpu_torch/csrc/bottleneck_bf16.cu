// Kernels K6 and K7: the bf16 stride-1 bottlenecks of the folded (serving) ResNet trunks.
//
// Replaces (embodied_clip_tpu/ops/pallas/bottleneck_kernel.py):
//   K6 fused_bottleneck  one stride-1 bottleneck, BN folded:
//                        h1 = bf16(relu(x·w1 + b1)); h2 = bf16(relu(conv3x3(h1, w2) + b2));
//                        out = bf16(relu(h2·w3 + b3 + x))
//   K7 fused_stage1      the whole stage 1: block 0 maps Cin → Cout with the 1×1 conv
//                        shortcut x·wsc + bsc added before the block relu; the identity
//                        blocks after it are K6's function
// The host wrappers (embodied_clip_tpu_torch/ops/kernels/bottleneck_kernel.py) run K6 as
// 3 launches of the one kernel below and K7 as 3 per block.
//
// Bound on an H100 at batch 128 (RN50 shapes; 3.35 TB/s, 989 TFLOP/s dense bf16): K7
// does 1.71e11 operations against ~0.2 GB of input, output and weights (≈0.173 ms,
// operations); a stage-3 or stage-4 K6 call ≈5.6e10 operations (≈0.0565 ms, operations);
// a stage-2 K6 call moves ≈0.2 GB for 5.6e10 operations (≈0.061 ms, bytes).
//
// Design. A TPU core keeps a whole image's stage in VMEM; one RN50 stage-1 image is
// 56·56·256 bf16 = 1.6 MB, far above one SM's 227 KB of shared memory. So a bottleneck is
// three launches of one tensor-core GEMM, each with its epilogue fused, and the Cm-wide
// intermediates h1/h2 (¼ of C) go through device memory (mostly L2) as bf16:
//   (a) 1×1 conv: A = the pixel rows of x (M = N·H·W, K = C), + bias, relu → bf16
//   (b) 3×3 conv, stride 1, zero halo, as an implicit GEMM: K = 9·Cm, k = (ky·3+kx)·Cm + c
//       (the HWIO weight flattened), the halo gathered while staging A (cp.async with a
//       zero fill for taps outside the image), + bias, relu → bf16
//   (c) 1×1 conv + bias + residual (bf16 x) + relu → bf16; for K7's block 0 the conv
//       shortcut is a second K loop over x·wsc into the same f32 accumulator, with bsc
//       added beside b3.
// Products run on the tensor cores: warp-level mma.sync.m16n8k16 bf16 × bf16 → f32 with
// operands read by ldmatrix (.trans for the row-major (K, N) weights, so no repacked
// copy of the weights exists). The tensor cores' f32 accumulation truncates; with one
// accumulator through the whole K loop its bias flipped bf16 roundings of h1/h2 on up to
// 5% of outputs at RN50 and RN50x16 widths (measured against the plain version); so
// each 32-k chunk is summed in fresh registers and added to the running f32 sum with an
// IEEE add, which keeps the truncation to 32-term partial sums. A block computes a
// 128 × 64 output tile with 8 warps of 32 × 32; A and B chunks of 32 k are staged through
// a 3-deep cp.async ring (staged rows padded by 16 B so ldmatrix is free of bank
// conflicts); 80-95 registers a thread leave room for two blocks per SM. K is streamed
// in those chunks, so stage 4's 4.7 MB w2 never has to fit anywhere; at M = 6272
// (stage 4) the 64-wide N tiles still give 8 × 49 = 392 blocks for 132 SMs. Measured and
// not kept: 128 × 128 tiles with 64 × 32 warp tiles need ~190 registers with the chunk
// sums, fit one block per SM and ran the bf16 encode 6% slower; promoting after every
// mma instead of every chunk fits two blocks and ran 3% faster, but disagreed with the
// plain version on more outputs (1.1% on a stage-4 call of the main path); promoting
// every 4 chunks (128 k) disagreed more at stage 3 (0.38% against 0.07%); a 4- or 6-deep
// ring was no faster than 3, so load latency is not what holds the kernel back. A chunk's k
// beyond K stages as zero, so any K that is a multiple of 8 works (Cm = 8 at test width
// pads 8 → 16 per mma).
// Epilogues add in f32 and round once with __float2bfloat16_rn, at the TPU kernel's three
// points. wgmma, TMA and warp specialisation are later work.
//
// Layouts: activations NHWC bf16 flattened to (M, C) rows; weights (K, N) bf16 row-major
// as the JAX package keeps them; biases f32. C, Cm and every pointer 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 8 warps: 4 along M × 2 along N
constexpr int kBM = 128;            // output rows (pixels) per block
constexpr int kBN = 64;             // output columns per block
constexpr int kBK = 32;             // k per staged chunk
constexpr int kStages = 3;          // cp.async ring depth
constexpr int kAStride = kBK + 8;   // bf16 per staged A row: 80 B
constexpr int kBStride = kBN + 8;   // bf16 per staged B row: 144 B

struct Gemm {
  const __nv_bfloat16* a;    // kRows: (M, K) rows; conv3: NHWC (M = n·H·W, C), K = 9·C
  const __nv_bfloat16* b;    // (K, N) row-major
  int K;
  const __nv_bfloat16* a2;   // second product (K7's shortcut): (M, K2) rows, or null
  const __nv_bfloat16* b2;   // (K2, N)
  int K2;
  const float* bias;         // (N)
  const float* bias2;        // (N), or null
  const __nv_bfloat16* res;  // (M, N) residual, or null
  __nv_bfloat16* out;        // (M, N)
  int M, N;
  int H, W, C;               // conv3 geometry
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d += a (16×16, row) · b (16×8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage chunk t of A: 128 rows × 32 k as 512 groups of 8 bf16 (16 B); this thread
// stages the groups (row tid/4 + 64j, k group tid%4), j = 0, 1. Chunks t ≥ T1 come from
// the second product. Rows past M, k past K and taps outside the image stage as zero.
template <bool CONV3>
__device__ __forceinline__ void load_a(const Gemm& p, int t, int T1, __nv_bfloat16* As,
                                       int m0, int tid, const int (&img)[2],
                                       const int (&py)[2], const int (&px)[2]) {
  const bool second = t >= T1;
  const __nv_bfloat16* src = second ? p.a2 : p.a;
  const int K = second ? p.K2 : p.K;
  const int kg = tid & 3;
  const int k = (second ? t - T1 : t) * kBK + kg * 8;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = (tid >> 2) + 64 * j;
    const int m = m0 + row;
    const __nv_bfloat16* g = src;  // any mapped address: no byte is read when bytes = 0
    int bytes = 0;
    if (m < p.M && k < K) {
      if (CONV3 && !second) {
        const int tap = k / p.C, c = k - tap * p.C;
        const int yy = py[j] + tap / 3 - 1, xx = px[j] + tap % 3 - 1;
        if (yy >= 0 && yy < p.H && xx >= 0 && xx < p.W) {
          g = src + (((size_t)img[j] * p.H + yy) * p.W + xx) * p.C + c;
          bytes = 16;
        }
      } else {
        g = src + (size_t)m * K + k;
        bytes = 16;
      }
    }
    cp_async16(As + row * kAStride + kg * 8, g, bytes);
  }
}

// Stage chunk t of B: 32 k-rows × 64 columns, one 16-byte group per thread.
__device__ __forceinline__ void load_b(const Gemm& p, int t, int T1, __nv_bfloat16* Bs,
                                       int n0, int tid) {
  const bool second = t >= T1;
  const __nv_bfloat16* src = second ? p.b2 : p.b;
  const int K = second ? p.K2 : p.K;
  const int kr = tid >> 3, ng = tid & 7;
  const int k = (second ? t - T1 : t) * kBK + kr;
  const int n = n0 + ng * 8;
  const bool ok = k < K && n < p.N;
  cp_async16(Bs + kr * kBStride + ng * 8, ok ? src + (size_t)k * p.N + n : src, ok ? 16 : 0);
}

// out = bf16(relu(A·B [+ A2·B2] + bias [+ bias2] [+ res])). Grid (ceil(M/128), ceil(N/64)).
template <bool CONV3>
__global__ void __launch_bounds__(kThreads) gemm_bf16_kernel(const Gemm p) {
  __shared__ __align__(128) __nv_bfloat16 As[kStages][kBM * kAStride];
  __shared__ __align__(128) __nv_bfloat16 Bs[kStages][kBK * kBStride];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  int img[2] = {0, 0}, py[2] = {0, 0}, px[2] = {0, 0};
  if (CONV3) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + (tid >> 2) + 64 * j;
      if (m < p.M) {
        img[j] = m / (p.H * p.W);
        const int rem = m - img[j] * p.H * p.W;
        py[j] = rem / p.W;
        px[j] = rem - py[j] * p.W;
      }
    }
  }

  const int T1 = (p.K + kBK - 1) / kBK;
  const int T = T1 + (p.a2 ? (p.K2 + kBK - 1) / kBK : 0);
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T) {
      load_a<CONV3>(p, s, T1, As[s], m0, tid, img, py, px);
      load_b(p, s, T1, Bs[s], n0, tid);
    }
    cp_async_commit();
  }

  for (int t = 0; t < T; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk t has landed, and every warp is done with chunk t-1
    const int nt = t + kStages - 1;
    if (nt < T) {
      load_a<CONV3>(p, nt, T1, As[nt % kStages], m0, tid, img, py, px);
      load_b(p, nt, T1, Bs[nt % kStages], n0, tid);
    }
    cp_async_commit();

    const __nv_bfloat16* as = As[t % kStages];
    const __nv_bfloat16* bs = Bs[t % kStages];
    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], as + (wm * 32 + mi * 16 + (lane & 15)) * kAStride + kk +
                                (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4_trans(bf[nj], bs + (kk + (lane & 15)) * kBStride + wn * 32 + nj * 16 +
                                      (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(part[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2], bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
  }
  cp_async_wait<0>();

  // Epilogue. Thread (g, t4) of a warp holds, per 16 × 8 tile, columns 2·t4 and 2·t4+1 of
  // rows g and g+8: one bf16 pair per row.
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = n0 + wn * 32 + ni * 8 + 2 * t4;
    if (n >= p.N) continue;
    const float2 b = *reinterpret_cast<const float2*>(p.bias + n);
    const float2 b2 = p.bias2 ? *reinterpret_cast<const float2*>(p.bias2 + n)
                              : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * 32 + mi * 16 + g + 8 * half;
        if (m >= p.M) continue;
        const size_t off = (size_t)m * p.N + n;
        float v0 = acc[mi][ni][2 * half] + b.x;
        float v1 = acc[mi][ni][2 * half + 1] + b.y;
        if (p.bias2) {
          v0 += b2.x;
          v1 += b2.y;
        }
        if (p.res) {
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.res + off));
          v0 += r.x;
          v1 += r.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(p.out + off) =
            __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
      }
    }
  }
}

}  // namespace

// Plain C interface for ctypes. Returns a cudaError_t code: 0 on a clean launch.
// One fused GEMM: out (M, N) = bf16(relu(A·B [+ a2·b2] + bias [+ bias2] [+ res])).
// conv3_c > 0: A is NHWC (M = n·H·W pixels, conv3_c channels) and the product is the
// 3×3 'SAME' convolution with B the HWIO kernel flattened to (9·conv3_c, N).
extern "C" int ect_gemm_bf16(const void* a, int M, int K, const void* b, int N,
                             const void* bias, const void* a2, int K2, const void* b2,
                             const void* bias2, const void* res, void* out, int conv3_c,
                             int H, int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0) return 0;
  Gemm p{static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), K,
         static_cast<const __nv_bfloat16*>(a2), static_cast<const __nv_bfloat16*>(b2), K2,
         static_cast<const float*>(bias), static_cast<const float*>(bias2),
         static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(out), M, N,
         H, W, conv3_c};
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (conv3_c > 0)
    gemm_bf16_kernel<true><<<grid, kThreads, 0, s>>>(p);
  else
    gemm_bf16_kernel<false><<<grid, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* ect_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
