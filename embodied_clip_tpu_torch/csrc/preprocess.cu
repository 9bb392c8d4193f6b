// Kernel K1: fused uint8 frames → PIL-bicubic resize + centre crop + per-pass uint8
// round/clip + normalise, in one launch.
//
// Replaces: embodied_clip_tpu/ops/pallas/preprocess_kernel.py, fused_preprocess_pallas
// (kernel body _kernel). Same function: x (N, H, W·3) uint8, channel-interleaved;
//   a = q(x · Kron(Ww, I3)ᵀ)          width pass  → (H, S·3)
//   b = q(Wh · a)                      height pass → (S, S·3)
//   out = b · (1/(255·std)) − mean/std  → (N, S, S, 3) f32 or bf16
// with q(v) = clamp(rint(v), 0, 255) (PIL stores each pass as uint8; rint rounds half
// to even like jnp.round). Ww, Wh come from resize_plan((H, W), S, (S, S)), which
// folds the centre crop into the rows.
//
// Bound on an H100: memory. Per 300×300 frame it reads 270,000 B of uint8 and writes
// 301,056 B of bf16 (602,112 B of f32) for about 5 MFLOP, far below the ~20 FLOP/B
// where f32 CUDA-core arithmetic would bind.
//
// Design. The TPU kernel bands a dense Kron matmul into 128-lane MXU tiles; here the
// matrices' sparsity is used instead. The host turns Ww and Wh into per-output-index
// tap tables (start index + T f32 weights; T ≈ 7 at 300→224, sized from the plan).
// Grid (image, tile of output rows). A block
//   1. copies the input rows its output rows need (one contiguous chunk) into shared
//      memory with coalesced 4-byte loads;
//   2. runs the width pass over those rows into shared memory. After q() every value
//      is an integer in 0..255, so the intermediate is stored as uint8, exactly —
//      a quarter of the f32 footprint;
//   3. runs the height pass, q(), normalise, and writes its rows coalesced.
// Every intermediate stays on chip; device memory sees one read of the frame and one
// write of the output, plus rows re-read by neighbouring tiles from L2. Weights stay
// f32 (the TPU kernel multiplies in bf16), and the sums use explicit fmaf so that the
// compiler cannot contract them differently from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float quantize_u8(float v) {
  return fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads) fused_preprocess_kernel(
    const uint8_t* __restrict__ x,      // (N, H, W*3)
    OutT* __restrict__ out,             // (N, S, S*3)
    const int* __restrict__ w_start,    // (S) first input column of output column o
    const float* __restrict__ w_taps,   // (S, Tw)
    const int* __restrict__ h_start,    // (S) first input row of output row r
    const float* __restrict__ h_taps,   // (S, Th)
    const int* __restrict__ tile_in0,   // (n_tiles) first input row a row tile needs
    const int* __restrict__ tile_span,  // (n_tiles) number of input rows it needs
    int H, int W, int S, int Tw, int Th, int rows_per_tile, int max_span, int vec4,
    float inv0, float inv1, float inv2, float sh0, float sh1, float sh2) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int W3 = W * 3, S3 = S * 3;
  uint8_t* xs = smem;                          // (max_span, W3) input rows
  uint8_t* as = smem + (size_t)max_span * W3;  // (max_span, S3) width-pass result
  const int img = blockIdx.x, tile = blockIdx.y;
  const int in0 = tile_in0[tile], span = tile_span[tile];
  const int r0 = tile * rows_per_tile;
  const int nrows = min(rows_per_tile, S - r0);

  // 1. Input rows [in0, in0 + span): one contiguous chunk of the image.
  const uint8_t* src = x + ((size_t)img * H + in0) * W3;
  const int nbytes = span * W3;
  if (vec4) {
    const uint32_t* s4 = reinterpret_cast<const uint32_t*>(src);
    uint32_t* d4 = reinterpret_cast<uint32_t*>(xs);
    for (int i = threadIdx.x; i < nbytes / 4; i += kThreads) d4[i] = __ldg(s4 + i);
  } else {
    for (int i = threadIdx.x; i < nbytes; i += kThreads) xs[i] = __ldg(src + i);
  }
  __syncthreads();

  // 2. Width pass: as[i][o*3+c] = q(sum_t w_taps[o][t] * xs[i][(w_start[o]+t)*3+c]).
  for (int e = threadIdx.x; e < span * S3; e += kThreads) {
    const int i = e / S3, j = e - i * S3;
    const int o = j / 3, c = j - o * 3;
    const uint8_t* px = xs + i * W3 + __ldg(w_start + o) * 3 + c;
    const float* wt = w_taps + o * Tw;
    float acc = 0.0f;
    for (int t = 0; t < Tw; ++t) acc = __fmaf_rn(__ldg(wt + t), (float)px[3 * t], acc);
    as[e] = (uint8_t)quantize_u8(acc);
  }
  __syncthreads();

  // 3. Height pass, q(), normalise, write (coalesced along the S*3 row).
  for (int e = threadIdx.x; e < nrows * S3; e += kThreads) {
    const int rr = e / S3, j = e - rr * S3;
    const int r = r0 + rr, c = j % 3;
    const uint8_t* pa = as + (__ldg(h_start + r) - in0) * S3 + j;
    const float* wt = h_taps + r * Th;
    float acc = 0.0f;
    for (int t = 0; t < Th; ++t) acc = __fmaf_rn(__ldg(wt + t), (float)pa[t * S3], acc);
    const float b = quantize_u8(acc);
    const float inv = c == 0 ? inv0 : (c == 1 ? inv1 : inv2);
    const float sh = c == 0 ? sh0 : (c == 1 ? sh1 : sh2);
    store(out + ((size_t)img * S + r) * S3 + j, __fsub_rn(__fmul_rn(b, inv), sh));
  }
}

template <typename OutT>
cudaError_t launch(const void* x, void* out, const void* w_start, const void* w_taps,
                   const void* h_start, const void* h_taps, const void* tile_in0,
                   const void* tile_span, int n, int H, int W, int S, int Tw, int Th,
                   int rows_per_tile, int n_tiles, int max_span, int vec4,
                   const float* inv, const float* sh, cudaStream_t stream) {
  const size_t smem = (size_t)max_span * (size_t)(W * 3 + S * 3);
  auto kern = fused_preprocess_kernel<OutT>;
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3(n, n_tiles), kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<OutT*>(out),
      static_cast<const int*>(w_start), static_cast<const float*>(w_taps),
      static_cast<const int*>(h_start), static_cast<const float*>(h_taps),
      static_cast<const int*>(tile_in0), static_cast<const int*>(tile_span),
      H, W, S, Tw, Th, rows_per_tile, max_span, vec4,
      inv[0], inv[1], inv[2], sh[0], sh[1], sh[2]);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. Returns a cudaError_t code: 0 on a clean launch.
extern "C" int ect_fused_preprocess(
    const void* x, void* out, const void* w_start, const void* w_taps,
    const void* h_start, const void* h_taps, const void* tile_in0,
    const void* tile_span, int n, int H, int W, int S, int Tw, int Th,
    int rows_per_tile, int n_tiles, int max_span, int vec4, int out_bf16,
    float inv0, float inv1, float inv2, float sh0, float sh1, float sh2,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float inv[3] = {inv0, inv1, inv2};
  const float sh[3] = {sh0, sh1, sh2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = out_bf16
      ? launch<__nv_bfloat16>(x, out, w_start, w_taps, h_start, h_taps, tile_in0,
                              tile_span, n, H, W, S, Tw, Th, rows_per_tile, n_tiles,
                              max_span, vec4, inv, sh, s)
      : launch<float>(x, out, w_start, w_taps, h_start, h_taps, tile_in0, tile_span,
                      n, H, W, S, Tw, Th, rows_per_tile, n_tiles, max_span, vec4,
                      inv, sh, s);
  return (int)err;
}

extern "C" const char* ect_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
