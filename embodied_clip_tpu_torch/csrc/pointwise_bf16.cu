// The per-element chains of the CLIP transformer blocks in bf16, one launch each:
//   - the LayerNorm over the last axis: f32 statistics and f32 affine with the f32 weight
//     and bias, one rounding to bf16; optionally after the block's residual add,
//     s = bf16(x + d) (PyTorch's bf16 add: the f32 sum rounded once), which it writes
//     beside LN(s);
//   - QuickGELU, y · σ(1.702 y), with the plain chain's three bf16 roundings:
//     t = bf16(1.702f · y), σ = bf16(1 / (1 + expf(-t))) (the accurate expf, IEEE
//     division: PyTorch's sigmoid), bf16(y · σ).
//
// Replaces no TPU kernel: the JAX package leaves both to XLA
// (`embodied_clip_tpu/models/transformer.py`). The port's plain route
// (`ops/kernels/pointwise_kernel.py`: `layer_norm_f32(x, ln).to(bf16)`, `quick_gelu`) is
// three passes each: a bf16 → f32 copy, the f32 LayerNorm and an f32 → bf16 copy (at
// ViT-L/14@336px's batch 128, 73,856 rows of 1,024: 1.36 GB moved against the 302 MB the
// function needs), and 1.702·y, σ, y·σ over the (73,856 × 4,096) hidden tensor (4.2 GB
// against 1.21 GB).
//
// Bound: bytes. A few operations an element, far below the H100's ridge: each launch
// reads its bf16 inputs once and writes its bf16 outputs once (LayerNorm 302 MB, with
// the residual 604 MB, QuickGELU 1.21 GB at that shape: 0.090, 0.181, 0.361 ms at
// 3.35 TB/s).
//
// Design:
// - LayerNorm: one warp a row, 8 rows a block of 256 threads. Each lane holds N 16-byte
//   vectors of the row (8 elements each; N = ⌈C / 256⌉, templated) in registers, all
//   loads issued before the first use, so the row is read once for the mean, the centred
//   sum of squares (two passes over registers, not Welford) and the write; weight and
//   bias come from L1. The residual form loads x and d, adds, stores s and goes on from
//   the rounded s, as the plain chain does.
// - QuickGELU: grid-stride over 16-byte vectors, four loads in flight a thread before
//   any is used. Computing the chain in full takes an accurate expf and an IEEE
//   division an element (~30 instructions, as long as its bytes take), but its bf16
//   result depends on the 16 bits of y alone. So a first launch on each device fills a
//   65,536-entry table of results with that arithmetic, each block (one an SM, 1,024
//   threads) copies the table (128 KB) into shared memory, and an element costs one
//   shared-memory load. Measured on an H100 at ViT-L/14@336px's batch 128 (PERF.md §6):
//   computing every element 0.505 ms, the table 0.426 (bound 0.361).
//
// Inputs and outputs are contiguous, 16-byte aligned, C a multiple of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // LayerNorm: 8 warps, 8 rows a block
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kGeluThreads = 1024;     // one block an SM (the table fills shared memory)
constexpr int kGeluUnroll = 4;         // 16-byte loads in flight a thread
constexpr int kTableEntries = 65536;
constexpr int kTableBytes = kTableEntries * 2;
constexpr int kMaxWidth = 4096;
constexpr int kBadShape = 9001;

// The bf16 results of QuickGELU for every bf16 input, by bit pattern (a copy on each
// device, filled by gelu_table_kernel before that device's first QuickGELU launch).
__device__ uint16_t g_gelu_table[kTableEntries];

__device__ __forceinline__ float round_bf16(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------------------ LayerNorm

template <int N, bool RES>
__global__ void __launch_bounds__(kThreads)
layer_norm_kernel(const uint4* __restrict__ x, const uint4* __restrict__ d,
                  uint4* __restrict__ s, uint4* __restrict__ y,
                  const float4* __restrict__ weight, const float4* __restrict__ bias,
                  long long rows, int nv, int c, float eps) {
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const size_t base = (size_t)row * nv;
  uint4 v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int j = lane + 32 * i;
    v[i] = j < nv ? x[base + j] : make_uint4(0u, 0u, 0u, 0u);
  }
  if constexpr (RES) {
    uint4 e[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int j = lane + 32 * i;
      e[i] = j < nv ? d[base + j] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float a[8], b[8];
      unpack8(v[i], a);
      unpack8(e[i], b);
#pragma unroll
      for (int k = 0; k < 8; ++k) a[k] += b[k];
      v[i] = pack8(a);
      if (lane + 32 * i < nv) s[base + lane + 32 * i] = v[i];
    }
  }
  float sum = 0.f;   // the padding vectors are zeros: they add nothing here
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float f[8];
    unpack8(v[i], f);
#pragma unroll
    for (int k = 0; k < 8; ++k) sum += f[k];
  }
  const float mean = warp_sum(sum) / (float)c;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (lane + 32 * i >= nv) continue;
    float f[8];
    unpack8(v[i], f);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float dv = f[k] - mean;
      sq = fmaf(dv, dv, sq);
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)c + eps);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int j = lane + 32 * i;
    if (j >= nv) continue;
    const float4 w0 = __ldg(weight + 2 * j), w1 = __ldg(weight + 2 * j + 1);
    const float4 b0 = __ldg(bias + 2 * j), b1 = __ldg(bias + 2 * j + 1);
    const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    float f[8];
    unpack8(v[i], f);
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] = fmaf(w[k], rstd * (f[k] - mean), b[k]);
    y[base + j] = pack8(f);
  }
}

using LayerNormKernel = void (*)(const uint4*, const uint4*, uint4*, uint4*, const float4*,
                                 const float4*, long long, int, int, float);

template <bool RES>
LayerNormKernel layer_norm_for(int n) {
  switch (n) {
    case 1: return layer_norm_kernel<1, RES>;
    case 2: return layer_norm_kernel<2, RES>;
    case 3: return layer_norm_kernel<3, RES>;
    case 4: return layer_norm_kernel<4, RES>;
    case 8: return layer_norm_kernel<8, RES>;
    default: return layer_norm_kernel<16, RES>;
  }
}

// ------------------------------------------------------------------------ QuickGELU

// The plain chain's function of one bf16 value y (as f32), before its last rounding.
__device__ __forceinline__ float quick_gelu_f32(float y) {
  const float t = round_bf16(1.702f * y);
  const float sg = round_bf16(1.0f / (1.0f + expf(-t)));
  return y * sg;
}

__global__ void gelu_table_kernel() {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < kTableEntries)
    g_gelu_table[i] = __bfloat16_as_ushort(
        __float2bfloat16_rn(quick_gelu_f32(__uint_as_float((uint32_t)i << 16))));
}

__device__ __forceinline__ uint32_t lookup2(const uint16_t* table, uint32_t w) {
  return (uint32_t)table[w & 0xffffu] | ((uint32_t)table[w >> 16] << 16);
}

__global__ void __launch_bounds__(kGeluThreads, 1)
quick_gelu_kernel(const uint4* __restrict__ y, uint4* __restrict__ out, long long nv) {
  extern __shared__ __align__(16) uint16_t table[];
  const uint4* src = reinterpret_cast<const uint4*>(g_gelu_table);
  for (int i = threadIdx.x; i < kTableBytes / 16; i += kGeluThreads)
    reinterpret_cast<uint4*>(table)[i] = src[i];
  __syncthreads();
  const long long step = (long long)gridDim.x * kGeluThreads * kGeluUnroll;
  for (long long i0 = (long long)blockIdx.x * kGeluThreads * kGeluUnroll + threadIdx.x;
       i0 < nv; i0 += step) {
    uint4 v[kGeluUnroll];
#pragma unroll
    for (int u = 0; u < kGeluUnroll; ++u) {
      const long long i = i0 + (long long)u * kGeluThreads;
      if (i < nv) v[u] = y[i];
    }
#pragma unroll
    for (int u = 0; u < kGeluUnroll; ++u) {
      const long long i = i0 + (long long)u * kGeluThreads;
      if (i < nv)
        out[i] = make_uint4(lookup2(table, v[u].x), lookup2(table, v[u].y),
                            lookup2(table, v[u].z), lookup2(table, v[u].w));
    }
  }
}

struct DeviceState {
  bool ready = false;
  int sms = 0;
};
DeviceState g_state[64];

// Per device, once: its SM count, the QuickGELU kernel's shared-memory limit, and its
// table filled (on `stream`, so ahead of the launch that follows).
int prepare(int device, cudaStream_t stream) {
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  DeviceState& st = g_state[device];
  if (st.ready) return 0;
  err = cudaDeviceGetAttribute(&st.sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(quick_gelu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTableBytes);
  if (err != cudaSuccess) return (int)err;
  gelu_table_kernel<<<kTableEntries / kThreads, kThreads, 0, stream>>>();
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  st.ready = true;
  return 0;
}

}  // namespace

// x (rows, c) bf16 → y (rows, c) bf16: LayerNorm with f32 weight and bias (c,). With
// `d` not null, first s = bf16(x + d), written to `s`, and y = LayerNorm(s). Returns a
// cudaError_t, or kBadShape.
extern "C" int ect_layer_norm_bf16(const void* x, const void* d, void* s, void* y,
                                   const void* weight, const void* bias, long long rows,
                                   int c, float eps, int device, void* stream) {
  if (rows < 0 || c < 8 || c > kMaxWidth || c % 8 || (d != nullptr) != (s != nullptr))
    return kBadShape;
  if ((rows + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffffLL) return kBadShape;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  const int nv = c / 8, per_lane = (nv + 31) / 32;
  const int n = per_lane <= 4 ? per_lane : per_lane <= 8 ? 8 : 16;
  const LayerNormKernel kernel = d ? layer_norm_for<true>(n) : layer_norm_for<false>(n);
  const unsigned blocks = (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(d), static_cast<uint4*>(s),
      static_cast<uint4*>(y), static_cast<const float4*>(weight),
      static_cast<const float4*>(bias), rows, nv, c, eps);
  return (int)cudaGetLastError();
}

// y (n elements, n a multiple of 8) bf16 → out = QuickGELU(y) bf16.
extern "C" int ect_quick_gelu_bf16(const void* y, void* out, long long n, int device,
                                   void* stream) {
  if (n < 0 || n % 8) return kBadShape;
  int err = prepare(device, (cudaStream_t)stream);
  if (err) return err;
  if (n == 0) return 0;
  const long long nv = n / 8;
  const long long per_block = (long long)kGeluThreads * kGeluUnroll;
  const long long blocks = (nv + per_block - 1) / per_block;
  const int grid = (int)(blocks < g_state[device].sms ? blocks : g_state[device].sms);
  quick_gelu_kernel<<<grid, kGeluThreads, kTableBytes, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(y), static_cast<uint4*>(out), nv);
  return (int)cudaGetLastError();
}

extern "C" const char* ect_error_string(int code) {
  if (code == kBadShape)
    return "pointwise: LayerNorm rows ≥ 0 of 8 ≤ C ≤ 4096, C a multiple of 8, the residual "
           "and its sum given together; QuickGELU a multiple of 8 elements";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
