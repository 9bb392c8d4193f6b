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
//   (a) gemm_s8_kernel<kRows>   s8×s8→s32 1×1 conv (a GEMM over pixel rows)
//   (b) gemm_s8_kernel<kConv3>  s8 3×3 conv, stride 1, zero halo, as an implicit GEMM
//                               (K = 9·C, the halo gathered while staging A)
//   (c) cb3_cb1_kernel          K4: a tile of BM pixel rows computes all C columns of
//                               cb3 + residual + requant into shared memory, then the
//                               next block's cb1 + requant from there; the block output
//                               is written once and never read back
//   (d) shortcut_bf16_kernel    K3's 1×1 conv shortcut in bf16 with f32 accumulation
//                               and the signed s8 requant
//
// Arithmetic. Products are __dp4a on four packed s8 pairs with int32 accumulation:
// exact at every K (|acc| ≤ 9·512·127² < 2³¹), so the TPU kernels' K ≤ 1024 bf16 route
// and K > 1024 s32 route are one route here. Epilogues follow the JAX graph's op order
// (embodied_clip_tpu/ops/quantize.py:443 and :597-609), each op rounded on its own:
//   v = float(acc)·S[n] + b[n];  v = v + float(res)·r_res;  q = trunc(clip(v / r + 0.5,
//   0, 127)); signed: y = v / r, y ± 0.5 by sign, clip ±127, trunc.
// __fmul_rn/__fadd_rn/__fdiv_rn keep nvcc from contracting them into FMAs, so the
// result equals PyTorch's elementwise ops on the same values bit for bit.
//
// Bound on an H100: operations. At batch 128 the int8 work is ~158 GOP (stage 1) and
// 168 / 280 / 112 GOP (identity runs of stages 2/3/4) against 1,979 TOP/s of int8
// tensor cores; dp4a on the CUDA cores reaches a small fraction of that. This first
// version is simple and exact: 64-column tiles, 4×4 outputs per thread, A and B staged
// through shared memory in chunks of 64 k. wgmma/TMA are later work.
//
// Layouts. Activations are NHWC s8, flattened to (M = N·H·W, C) rows. Weights come as
// the JAX package keeps them: (K, N) s8, row-major (1×1: (Cin, Cout); 3×3: HWIO
// flattened to (9·Cin, Cout), k = (ky·3 + kx)·Cin + c). While a B chunk is staged, four
// k-rows are transposed with __byte_perm into one dp4a word per column, so no packed
// copy of the weights is needed. All sizes in bytes along C must be multiples of 4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 column groups × 16 row lanes
constexpr int kBN = 64;        // output columns per tile
constexpr int kBK4 = 16;       // k words (4 s8 each) per staged chunk: 64 k
constexpr int kAStride = kBK4 + 1;  // padded row of a staged A chunk, in words

enum Src { kRows = 0, kConv3 = 1 };
enum Out { kS8 = 0, kS8Res = 1, kBf16ResRelu = 2, kF32ResRelu = 3 };

struct Epilogue {
  const float* S;       // (N) per-column scale, in_scale · w_scale
  const float* b;       // (N) bias
  const int8_t* res;    // (M, N) s8 residual, or null
  const float* r_res;   // residual scale (device scalar)
  const float* r_out;   // requant scale (device scalar)
  void* out;            // (M, N): s8, bf16 or f32
};

__device__ __forceinline__ int8_t requant_u8(float v, float r) {
  float y = __fadd_rn(__fdiv_rn(v, r), 0.5f);
  y = fminf(fmaxf(y, 0.0f), 127.0f);
  return (int8_t)(int)y;  // truncating convert, y ≥ 0
}

__device__ __forceinline__ int8_t requant_s8(float v, float r) {
  float y = __fdiv_rn(v, r);
  y = y >= 0.0f ? __fadd_rn(y, 0.5f) : __fsub_rn(y, 0.5f);
  y = fminf(fmaxf(y, -127.0f), 127.0f);
  return (int8_t)(int)y;  // truncating convert, toward zero
}

__device__ __forceinline__ float affine(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
}

__device__ __forceinline__ uint32_t pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return (uint32_t)(uint8_t)a | ((uint32_t)(uint8_t)b << 8) |
         ((uint32_t)(uint8_t)c << 16) | ((uint32_t)(uint8_t)d << 24);
}

// Stage B[k0 .. k0+64) × [n0 .. n0+64) of a row-major (K, N) s8 matrix into
// Bs[kBK4][kBN] words, Bs[kk][n] = {B[4kk+0][n], .., B[4kk+3][n]} (byte 0 lowest k).
// Thread (ty, tx) loads the 4×4 bytes at rows 4(k0w+ty)+r, columns n0+4tx+j and
// transposes them. Out-of-range rows and columns stage as zero.
__device__ __forceinline__ void stage_b(const int8_t* __restrict__ B, int K, int N,
                                        int k0w, int n0, int* __restrict__ Bs,
                                        int ty, int tx) {
  const int n = n0 + 4 * tx;
  uint32_t w[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = 4 * (k0w + ty) + r;
    w[r] = (k < K && n < N) ? __ldg(reinterpret_cast<const uint32_t*>(B + (size_t)k * N + n))
                            : 0u;
  }
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  int4 p;
  p.x = (int)__byte_perm(lo01, lo23, 0x5410);  // column n+0: rows 0..3
  p.y = (int)__byte_perm(lo01, lo23, 0x7632);  // column n+1
  p.z = (int)__byte_perm(hi01, hi23, 0x5410);  // column n+2
  p.w = (int)__byte_perm(hi01, hi23, 0x7632);  // column n+3
  *reinterpret_cast<int4*>(Bs + ty * kBN + 4 * tx) = p;
}

// acc[i][j] += Σ_kk A[row_i][kw0 + kk] · Bs[kk][4tx + j] over one staged chunk.
// A is a row-major word array with row stride a_stride; row_i = ty + 16 i.
template <int R>
__device__ __forceinline__ void dot_chunk(const int* __restrict__ A, int a_stride,
                                          int kw0, const int* __restrict__ Bs, int ty,
                                          int tx, int (&acc)[R][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK4; ++kk) {
    const int4 b = *reinterpret_cast<const int4*>(Bs + kk * kBN + 4 * tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int a = A[(ty + 16 * i) * a_stride + kw0 + kk];
      acc[i][0] = __dp4a(a, b.x, acc[i][0]);
      acc[i][1] = __dp4a(a, b.y, acc[i][1]);
      acc[i][2] = __dp4a(a, b.z, acc[i][2]);
      acc[i][3] = __dp4a(a, b.w, acc[i][3]);
    }
  }
}

// Apply the epilogue to a thread's R×4 outputs (rows m0+ty+16i, columns n0+4tx+j).
// With T, s8 results also go to shared memory: T[row][n/4] as one word of 4 columns.
template <int R>
__device__ __forceinline__ void epilogue(const Epilogue& e, int out_kind, int M, int N,
                                         int m0, int n0, int ty, int tx,
                                         const int (&acc)[R][4], int* T = nullptr,
                                         int t_stride = 0) {
  const int n = n0 + 4 * tx;
  if (n >= N) return;
  float S[4], b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) { S[j] = __ldg(e.S + n + j); b[j] = __ldg(e.b + n + j); }
  const float r_out = e.r_out ? __ldg(e.r_out) : 1.0f;
  const float r_res = e.r_res ? __ldg(e.r_res) : 0.0f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const size_t off = (size_t)m * N + n;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = affine(acc[i][j], S[j], b[j]);
    if (out_kind != kS8) {
      const uint32_t rw = __ldg(reinterpret_cast<const uint32_t*>(e.res + off));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float id = __fmul_rn((float)(int8_t)(rw >> (8 * j)), r_res);
        v[j] = __fadd_rn(v[j], id);
      }
    }
    if (out_kind == kS8 || out_kind == kS8Res) {
      const uint32_t q = pack4(requant_u8(v[0], r_out), requant_u8(v[1], r_out),
                               requant_u8(v[2], r_out), requant_u8(v[3], r_out));
      *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(e.out) + off) = q;
      if (T) T[(ty + 16 * i) * t_stride + n / 4] = (int)q;
    } else if (out_kind == kBf16ResRelu) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(fmaxf(v[0], 0.0f), fmaxf(v[1], 0.0f));
      __nv_bfloat162 hi = __floats2bfloat162_rn(fmaxf(v[2], 0.0f), fmaxf(v[3], 0.0f));
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
          static_cast<__nv_bfloat16*>(e.out) + off);
      o[0] = lo;
      o[1] = hi;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(e.out) + off) =
          make_float4(fmaxf(v[0], 0.0f), fmaxf(v[1], 0.0f), fmaxf(v[2], 0.0f),
                      fmaxf(v[3], 0.0f));
    }
  }
}

// (a)/(b): out = epilogue(A · B) for A the pixel rows of x (kRows: (M, K) s8) or the
// implicit 3×3 im2col of an NHWC (M = n·H·W, C) s8 tensor (kConv3: K = 9·C, zero
// halo). Grid (ceil(M / 16R), ceil(N / 64)); block kThreads.
template <int SRC, int R>
__global__ void __launch_bounds__(kThreads) gemm_s8_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ B, int M, int K, int N,
    int H, int W, int C, Epilogue e, int out_kind) {
  __shared__ __align__(16) int Bs[kBK4 * kBN];
  __shared__ int As[16 * R * kAStride];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * 16 * R, n0 = blockIdx.y * kBN;

  // Rows this thread stages (and later writes): m0 + ty + 16 r.
  int img[R], py[R], px[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int m = m0 + ty + 16 * r;
    img[r] = -1;
    if (SRC == kConv3 && m < M) {
      img[r] = m / (H * W);
      const int rem = m - img[r] * H * W;
      py[r] = rem / W;
      px[r] = rem - py[r] * W;
    }
  }

  int acc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  const int K4 = K / 4;
  for (int k0w = 0; k0w < K4; k0w += kBK4) {
    const int kw = k0w + tx;  // the A word this thread stages, in each of its rows
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = m0 + ty + 16 * r;
      int a = 0;
      if (kw < K4 && m < M) {
        if (SRC == kRows) {
          a = __ldg(reinterpret_cast<const int*>(x + (size_t)m * K) + kw);
        } else {
          const int k = 4 * kw;
          const int tap = k / C, c = k - tap * C;
          const int yy = py[r] + tap / 3 - 1, xx = px[r] + tap % 3 - 1;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W)
            a = __ldg(reinterpret_cast<const int*>(
                x + (((size_t)img[r] * H + yy) * W + xx) * C + c));
        }
      }
      As[(ty + 16 * r) * kAStride + tx] = a;
    }
    stage_b(B, K, N, k0w, n0, Bs, ty, tx);
    __syncthreads();
    dot_chunk<R>(As, kAStride, 0, Bs, ty, tx, acc);
    __syncthreads();
  }
  epilogue<R>(e, out_kind, M, N, m0, n0, ty, tx, acc);
}

// (c) K4. One block owns 16R pixel rows. A1 = x8 rows (M, Cm) stays in shared memory;
// for each 64-column tile of C: out = requant(x8·k3·S3 + b3 + res·r_res, r_out), kept
// in shared memory T (M, C) and written to out8; then y8 = requant(T·k1·S1 + b1,
// r_next) for each 64-column tile of C1. Dynamic shared memory: Bs | A1 | T.
template <int R>
__global__ void __launch_bounds__(kThreads) cb3_cb1_kernel(
    const int8_t* __restrict__ x8, const int8_t* __restrict__ res8, int M, int Cm,
    int C, int C1, const int8_t* __restrict__ k3, const float* __restrict__ S3,
    const float* __restrict__ b3, const int8_t* __restrict__ k1,
    const float* __restrict__ S1, const float* __restrict__ b1,
    const float* __restrict__ r_res, const float* __restrict__ r_out,
    const float* __restrict__ r_next, int8_t* __restrict__ out8,
    int8_t* __restrict__ y8, int a_stride, int t_stride) {
  extern __shared__ __align__(16) int smem[];
  int* Bs = smem;
  int* A1 = Bs + kBK4 * kBN;
  int* T = A1 + 16 * R * a_stride;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * 16 * R;
  const int Cm4 = Cm / 4, C4 = C / 4;

  // A1: the block's x8 rows, zero beyond M and beyond Cm (up to the padded stride).
  for (int e = threadIdx.x; e < 16 * R * (a_stride - 1); e += kThreads) {
    const int row = e / (a_stride - 1), kw = e - row * (a_stride - 1);
    const int m = m0 + row;
    A1[row * a_stride + kw] = (m < M && kw < Cm4)
        ? __ldg(reinterpret_cast<const int*>(x8 + (size_t)m * Cm) + kw) : 0;
  }
  __syncthreads();

  // Rows past M are never written to T; the y8 rows they feed are not stored.
  Epilogue e3{S3, b3, res8, r_res, r_out, out8};
  for (int n0 = 0; n0 < C; n0 += kBN) {
    int acc[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    for (int k0w = 0; k0w < Cm4; k0w += kBK4) {
      stage_b(k3, Cm, C, k0w, n0, Bs, ty, tx);
      __syncthreads();
      dot_chunk<R>(A1, a_stride, k0w, Bs, ty, tx, acc);
      __syncthreads();
    }
    epilogue<R>(e3, kS8Res, M, C, m0, n0, ty, tx, acc, T, t_stride);
  }
  // Zero T's padding words (C/4 .. t_stride-1) so the cb1 chunks read zeros there.
  for (int e = threadIdx.x; e < 16 * R * (t_stride - 1 - C4); e += kThreads) {
    const int row = e / (t_stride - 1 - C4), kw = C4 + e - row * (t_stride - 1 - C4);
    T[row * t_stride + kw] = 0;
  }
  __syncthreads();

  Epilogue e1{S1, b1, nullptr, nullptr, r_next, y8};
  for (int n0 = 0; n0 < C1; n0 += kBN) {
    int acc[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    for (int k0w = 0; k0w < C4; k0w += kBK4) {
      stage_b(k1, C, C1, k0w, n0, Bs, ty, tx);
      __syncthreads();
      dot_chunk<R>(T, t_stride, k0w, Bs, ty, tx, acc);
      __syncthreads();
    }
    epilogue<R>(e1, kS8, M, C1, m0, n0, ty, tx, acc);
  }
}

// (d) K3's conv shortcut: sc8 = requant_signed(bf16(float(x8)·s_in) · wsc + bsc, dsc),
// bf16 operands, f32 accumulation (each bf16 product is exact in f32). x8 (M, K) s8,
// wsc (K, N) bf16. Grid (ceil(M/64), ceil(N/64)).
__global__ void __launch_bounds__(kThreads) shortcut_bf16_kernel(
    const int8_t* __restrict__ x8, const __nv_bfloat16* __restrict__ wsc, int M, int K,
    int N, const float* __restrict__ s_in, const float* __restrict__ bsc,
    const float* __restrict__ dsc, int8_t* __restrict__ out8) {
  constexpr int kBK = 16;
  __shared__ float As[64 * (kBK + 1)];
  __shared__ __align__(16) float Bs[kBK * kBN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * 64, n0 = blockIdx.y * kBN;
  const float s = __ldg(s_in);
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // A: 64 rows × 16 k, one element per (row, tx)
      const int m = m0 + ty + 16 * r, k = k0 + tx;
      float a = 0.0f;
      if (m < M && k < K)
        a = __bfloat162float(__float2bfloat16_rn(__fmul_rn((float)x8[(size_t)m * K + k], s)));
      As[(ty + 16 * r) * (kBK + 1) + tx] = a;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // B: 16 k × 64 n
      const int k = k0 + ty, n = n0 + 4 * tx + j;
      Bs[ty * kBN + 4 * tx + j] = (k < K && n < N) ? __bfloat162float(wsc[(size_t)k * N + n])
                                                   : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(Bs + kk * kBN + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = As[(ty + 16 * i) * (kBK + 1) + kk];
        acc[i][0] = __fmaf_rn(a, b.x, acc[i][0]);
        acc[i][1] = __fmaf_rn(a, b.y, acc[i][1]);
        acc[i][2] = __fmaf_rn(a, b.z, acc[i][2]);
        acc[i][3] = __fmaf_rn(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
  const int n = n0 + 4 * tx;
  if (n >= N) return;
  const float d = __ldg(dsc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    int8_t q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = requant_s8(__fadd_rn(acc[i][j], __ldg(bsc + n + j)), d);
    *reinterpret_cast<uint32_t*>(out8 + (size_t)m * N + n) = pack4(q[0], q[1], q[2], q[3]);
  }
}

// Rows per thread: 4 (64-row tiles) when the grid still has ~2 tiles per SM, else 2.
inline bool wide_rows(int M, int N) {
  return (long long)((M + 63) / 64) * ((N + kBN - 1) / kBN) >= 264;
}

template <int SRC>
cudaError_t launch_gemm(const void* x, const void* B, int M, int K, int N, int H, int W,
                        int C, const Epilogue& e, int out_kind, cudaStream_t s) {
  if (wide_rows(M, N)) {
    dim3 grid((M + 63) / 64, (N + kBN - 1) / kBN);
    gemm_s8_kernel<SRC, 4><<<grid, kThreads, 0, s>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(B), M, K, N, H, W, C,
        e, out_kind);
  } else {
    dim3 grid((M + 31) / 32, (N + kBN - 1) / kBN);
    gemm_s8_kernel<SRC, 2><<<grid, kThreads, 0, s>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(B), M, K, N, H, W, C,
        e, out_kind);
  }
  return cudaGetLastError();
}

inline int padded_words(int bytes) {  // words of a resident row: chunk-padded, odd
  const int w = (bytes / 4 + kBK4 - 1) / kBK4 * kBK4;
  return w + 1;
}

}  // namespace

// Plain C interface for ctypes. Each returns a cudaError_t code: 0 on a clean launch.
// Scales named r_* are device pointers to one float.

extern "C" size_t ect_cb3_cb1_smem_bytes(int rows, int Cm, int C) {
  return sizeof(int) * ((size_t)kBK4 * kBN + (size_t)rows * padded_words(Cm) +
                        (size_t)rows * padded_words(C));
}

// (a) 1×1 conv: out_kind 0 = s8 requant, 1 = s8 requant with residual,
// 2 = bf16 relu(v + residual), 3 = f32 relu(v + residual).
extern "C" int ect_conv1x1_s8(const void* x8, int M, int K, const void* w8, int N,
                              const void* S, const void* b, const void* res,
                              const void* r_res, const void* r_out, void* out,
                              int out_kind, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Epilogue e{static_cast<const float*>(S), static_cast<const float*>(b),
             static_cast<const int8_t*>(res), static_cast<const float*>(r_res),
             static_cast<const float*>(r_out), out};
  return (int)launch_gemm<kRows>(x8, w8, M, K, N, 1, 1, K, e, out_kind,
                                 static_cast<cudaStream_t>(stream));
}

// (b) 3×3 conv, stride 1, zero halo, s8 requant epilogue. x8 (n, H, W, C).
extern "C" int ect_conv3x3_s8(const void* x8, int n, int H, int W, int C, const void* w8,
                              int N, const void* S, const void* b, const void* r_out,
                              void* out8, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Epilogue e{static_cast<const float*>(S), static_cast<const float*>(b), nullptr, nullptr,
             static_cast<const float*>(r_out), out8};
  return (int)launch_gemm<kConv3>(x8, w8, n * H * W, 9 * C, N, H, W, C, e, kS8,
                                  static_cast<cudaStream_t>(stream));
}

// (c) K4: returns (out8 (M, C), y8 (M, C1)). rows = 32 or 64 pixel rows per block.
extern "C" int ect_cb3_cb1_s8(const void* x8, const void* res8, int M, int Cm, int C,
                              int C1, const void* k3, const void* S3, const void* b3,
                              const void* k1, const void* S1, const void* b1,
                              const void* r_res, const void* r_out, const void* r_next,
                              void* out8, void* y8, int rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = ect_cb3_cb1_smem_bytes(rows, Cm, C);
  const int a_stride = padded_words(Cm), t_stride = padded_words(C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kern) -> cudaError_t {
    cudaError_t e2 = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)smem);
    if (e2 != cudaSuccess) return e2;
    kern<<<(M + rows - 1) / rows, kThreads, smem, s>>>(
        static_cast<const int8_t*>(x8), static_cast<const int8_t*>(res8), M, Cm, C, C1,
        static_cast<const int8_t*>(k3), static_cast<const float*>(S3),
        static_cast<const float*>(b3), static_cast<const int8_t*>(k1),
        static_cast<const float*>(S1), static_cast<const float*>(b1),
        static_cast<const float*>(r_res), static_cast<const float*>(r_out),
        static_cast<const float*>(r_next), static_cast<int8_t*>(out8),
        static_cast<int8_t*>(y8), a_stride, t_stride);
    return cudaGetLastError();
  };
  return (int)(rows == 64 ? run(cb3_cb1_kernel<4>) : run(cb3_cb1_kernel<2>));
}

// (d) K3's bf16 conv shortcut with the signed s8 requant.
extern "C" int ect_shortcut_bf16(const void* x8, const void* wsc, int M, int K, int N,
                                 const void* s_in, const void* bsc, const void* dsc,
                                 void* out8, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + 63) / 64, (N + kBN - 1) / kBN);
  shortcut_bf16_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x8), static_cast<const __nv_bfloat16*>(wsc), M, K, N,
      static_cast<const float*>(s_in), static_cast<const float*>(bsc),
      static_cast<const float*>(dsc), static_cast<int8_t*>(out8));
  return (int)cudaGetLastError();
}

extern "C" const char* ect_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
