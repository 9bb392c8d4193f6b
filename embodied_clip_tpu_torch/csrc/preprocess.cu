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
// 301,056 B of bf16 (602,112 B of f32) for about 4 MFLOP, ~7 FLOP/B, below the ~20
// FLOP/B where f32 CUDA-core arithmetic would bind. At that bound the card issues only
// about 14 thread-instructions per output, so the design counts instructions per tap.
//
// Design. The matrices' sparsity is used in place of the TPU kernel's banded Kron
// matmul: the host turns Ww and Wh into per-output tap tables (start index + T f32
// weights, T padded with zero weights to one of the compiled counts). A persistent grid
// walks work items: an item is a chunk of one image's output rows (the host sizes the
// chunks from the batch so that the items fill the card at batch 1 as at 128). Down a
// chunk the block walks bands of at most `band_rows` input rows:
//   1. one thread issues the band's bulk copy (cp.async.bulk, 1-D, completing on a
//      per-stage mbarrier) into a ring of kStages stages, kStages − 1 bands ahead, so
//      the next bands are in flight while this one is computed. A bulk copy needs
//      16-byte-aligned ends: it moves the band's 16-byte-aligned superset, clipped to the
//      frames' aligned interior, to the same offset from a 16-byte boundary in shared
//      memory; the few bytes of a frame tensor's first or last band outside it are read
//      with plain loads, never outside the frames, so any row width and data_ptr work;
//   2. every input byte is converted once, as the band is staged: a pixel's three bytes
//      → three f32 by __byte_perm into 0x4B0000xx and − 2²³ (exact), stored as exact
//      bf16 in one 8-byte slot (r, g, b, 0) a pixel;
//   3. the width pass computes each new input row once. A thread owns two neighbouring
//      output columns for the whole launch, their 2T + D tap weights in registers: one
//      8-byte load of a pixel (widened to f32 by shifts) feeds the six sums of both
//      columns, so each pixel of the T + D window is read once for six outputs (column
//      2p's taps are the window's first T; column 2p+1's sit at its offset, zeros
//      elsewhere). The host assigns the pairs to lanes, and picks the row stride, so
//      that a half-warp's loads fall in 16 different bank pairs.
//      After q() the row goes, as f32, into a ring of `ring_rows` = band_rows + T − 1
//      width-pass rows (input row i in slot i mod ring_rows), so rows shared by
//      neighbouring output rows are carried down the chunk, not recomputed;
//   4. the height pass emits every output row whose T input rows are now in the ring
//      (a table of the host gives their count): a thread owns 8 fixed output columns
//      (normalise constants in registers), reads two float4 of a ring row per tap (taps
//      and slots from shared memory), and writes 16 bytes (bf16) or 32 (f32).
// Device memory sees each frame read once (plus the T − 1 halo rows of each chunk) and
// the output written once. Weights stay f32 and the sums are explicit __fmaf_rn in tap
// order (a zero weight adds exactly 0 to a sum of finite values, so the padding changes
// nothing), with q() and the normalise as __fadd_rn/__fmul_rn/__fsub_rn: the arithmetic
// of the plain version.

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kBarrierBytes = 128;  // the stages' mbarriers, before the stages

struct PreParams {
  const uint8_t* x;           // (N, H, W·3)
  const uint8_t* x_end;       // one past its last byte
  void* out;                  // (N, S, S·3) f32 or bf16
  const int* w_start;         // (S) first input column of output column o
  const int* h_start;         // (S) first input row of output row r
  const int* h_slot;          // (S) its ring slot, h_start mod ring_rows
  const int* rows_done;       // (H + 1) output rows r with h_start[r] + T ≤ i
  const float* h_taps;        // (S, T)
  const int* thread_pair;     // (kThreads) width-pass column pair of a thread, or −1
  const int* thread_row;      // (kThreads) its first band row
  const float* thread_taps;   // (kThreads, 2T + D) its two columns' taps
  int H, W3, S, S3, S3p;      // S3p: a ring row's floats (S·3 rounded up to 8)
  int rows_par, xf_stride;    // width-pass rows at once; pixel slots per band row
  int band_rows, ring_rows, chunks, chunk_rows, items;
  int stage_bytes, out_bf16;
  float inv[3], sh[3];
};

// q(v) = clamp(rint(v), 0, 255). For |v| < 2²², v + 1.5·2²³ rounds v to an integer,
// half to even, as rintf does; two full-rate adds in place of FRND, which the card
// issues at a quarter of the FMA rate.
__device__ __forceinline__ float quantize_u8(float v) {
  constexpr float kRound = 12582912.0f;  // 1.5 · 2²³
  return fminf(fmaxf(__fsub_rn(__fadd_rn(v, kRound), kRound), 0.0f), 255.0f);
}

// The low three bytes of a word (a pixel's r, g, b) → three exact f32 (0x4B0000xx is
// 2²³ + xx), kept as bf16, which holds every integer 0 … 256 exactly: the top halves of
// the f32 words, packed as (r, g) and (b, 0).
__device__ __forceinline__ uint2 bytes_to_bf16(uint32_t v) {
  constexpr float k2p23 = 8388608.0f;
  uint32_t c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    c[i] = __float_as_uint(__fsub_rn(__int_as_float(__byte_perm(v, 0x4B00, 0x5440 + i)), k2p23));
  return make_uint2(__byte_perm(c[0], c[1], 0x7632), c[2] >> 16);
}

// A staged pixel → its (r, g, b) as f32, w = 0 (bf16 → f32 is exact: the low half of the
// f32 word is zero).
__device__ __forceinline__ float4 bf16_to_f32(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xFFFF0000u),
                     __uint_as_float(v.y << 16), 0.0f);
}

// A block's sequence of bands: items blockIdx.x, + gridDim.x, ...; in each, the input
// rows [h_start[r0], h_start[r1 − 1] + T) of its output rows [r0, r1), band_rows at a
// time. The producer thread and the consumers each walk their own copy.
template <int T>
struct Walk {
  int item, img, r0, r1, next, end;

  __device__ bool begin(const PreParams& p, int it) {
    item = it;
    next = end = 0;
    if (it >= p.items) return false;
    img = it / p.chunks;
    r0 = (it - img * p.chunks) * p.chunk_rows;
    r1 = min(p.S, r0 + p.chunk_rows);
    next = __ldg(p.h_start + r0);
    end = __ldg(p.h_start + r1 - 1) + T;
    return true;
  }
  // The next band [i0, i1); `first` when it opens an item. False when the walk is done.
  __device__ bool band(const PreParams& p, int& i0, int& i1, bool& first) {
    first = next >= end;
    if (first && !begin(p, item + gridDim.x)) return false;
    i0 = next;
    i1 = min(end, next + p.band_rows);
    next = i1;
    return true;
  }
};

__device__ __forceinline__ const uint8_t* band_src(const PreParams& p, int img, int i0) {
  return p.x + ((size_t)img * p.H + i0) * (size_t)p.W3;
}

// The band at device address a (nb bytes) lands in its stage at byte a mod 16. Its bulk
// copy moves the 16-byte-aligned superset of the band, clipped to the frames' aligned
// interior: stage bytes [off0, off1). Only the bytes of the band outside it (within 15 B
// of the frames' first or last byte, so only in a frame tensor's first or last band) are
// read with plain loads.
__device__ __forceinline__ void copied_range(const PreParams& p, uintptr_t a, size_t nb,
                                             int& off0, int& off1) {
  const uintptr_t base = a & ~uintptr_t(15);
  const uintptr_t lo = (reinterpret_cast<uintptr_t>(p.x) + 15) & ~uintptr_t(15);
  const uintptr_t hi = reinterpret_cast<uintptr_t>(p.x_end) & ~uintptr_t(15);
  const uintptr_t c0 = max(base, lo);
  const uintptr_t c1 = min((a + nb + 15) & ~uintptr_t(15), hi);
  off0 = (int)(c0 - base);
  off1 = c1 > c0 ? (int)(c1 - base) : off0;
}

// Issues the band's bulk copy. An empty copy still arrives (with no bytes).
__device__ __forceinline__ void issue_band(const PreParams& p, uint8_t* stage, uint64_t* bar,
                                           int img, int i0, int i1) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(band_src(p, img, i0));
  int off0, off1;
  copied_range(p, a, (size_t)(i1 - i0) * p.W3, off0, off1);
  mbar_expect_tx(bar, off1 - off0);
  if (off1 > off0)
    bulk_load(stage + off0, reinterpret_cast<const void*>((a & ~uintptr_t(15)) + off0),
              (uint32_t)(off1 - off0), bar);
}

template <int T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    preprocess_kernel(const __grid_constant__ PreParams p) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint8_t* stages = smem + kBarrierBytes;
  uint2* xf = reinterpret_cast<uint2*>(stages + (size_t)kStages * p.stage_bytes);
  float* ring = reinterpret_cast<float*>(xf + (size_t)p.band_rows * p.xf_stride);
  float* htaps = ring + (size_t)p.ring_rows * p.S3p;  // (S, T) height taps
  int* hslot = reinterpret_cast<int*>(htaps + p.S * T);  // (S) ring slots
  int* done = hslot + p.S;                                // (H + 1) rows_done
  const int tid = threadIdx.x;

  // A pair's window may run past its row's last pixel (into pad slots, the next row or
  // the ring) with zero weights: zero the converted band and the ring once, so that
  // every value such a tap reads is finite and the product is exactly 0.
  {
    const int n2 = p.band_rows * p.xf_stride + p.ring_rows * p.S3p / 2;
    for (int k = tid; k < n2; k += kThreads) xf[k] = make_uint2(0u, 0u);
    // the height pass's tables, read by every thread for every output row
    for (int k = tid; k < p.S * T; k += kThreads) htaps[k] = __ldg(p.h_taps + k);
    for (int k = tid; k < p.S; k += kThreads) hslot[k] = __ldg(p.h_slot + k);
    for (int k = tid; k <= p.H; k += kThreads) done[k] = __ldg(p.rows_done + k);
  }
  // Width pass: this thread's output columns 2·pair and 2·pair + 1 (all three channels)
  // read pixels px0 … px0 + T + D − 1 of band rows wrow, wrow + rows_par, …; column
  // 2·pair's taps are the window's first T, column 2·pair + 1's lie at its offset in
  // w1 (zeros elsewhere).
  const int pair = __ldg(p.thread_pair + tid);
  const int wrow = __ldg(p.thread_row + tid);
  const int px0 = pair >= 0 ? __ldg(p.w_start + 2 * pair) : 0;
  const bool second = pair >= 0 && 2 * pair + 1 < p.S;
  float w0[T], w1[T + D];
#pragma unroll
  for (int t = 0; t < T; ++t) w0[t] = __ldg(p.thread_taps + tid * (2 * T + D) + t);
#pragma unroll
  for (int t = 0; t < T + D; ++t) w1[t] = __ldg(p.thread_taps + tid * (2 * T + D) + T + t);
  // Height pass: this thread's group of 8 output elements g and its rows out_next +
  // rsub, + rows_par, ... (the plan keeps S·3 ≤ 8·kThreads). It loads the 16-byte half
  // `half` of its group first, so that a quarter-warp's loads fall in 8 bank groups.
  const int groups = p.S3p / 8;
  const int rows_par = kThreads / groups;
  const int rsub = tid / groups;
  const int g = tid - rsub * groups;
  const int half = (g >> 2) & 1;
  const bool vec_out = p.S3 % 8 == 0;
  float inv[8], sh[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int c = (g * 8 + m) % 3;
    inv[m] = c == 0 ? p.inv[0] : (c == 1 ? p.inv[1] : p.inv[2]);
    sh[m] = c == 0 ? p.sh[0] : (c == 1 ? p.sh[1] : p.sh[2]);
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Walk<T> prod;
  if (tid == 0) {  // the first kStages bands
    bool live = prod.begin(p, blockIdx.x);
    for (int s = 0; s < kStages && live; ++s) {
      int i0, i1;
      bool first;
      if ((live = prod.band(p, i0, i1, first)))
        issue_band(p, stages + (size_t)s * p.stage_bytes, &bars[s], prod.img, i0, i1);
    }
  }

  Walk<T> walk;
  walk.begin(p, blockIdx.x);
  int out_next = walk.r0, i0, i1;
  bool first;
  for (int kc = 0; walk.band(p, i0, i1, first); ++kc) {
    const int s = kc % kStages;
    uint8_t* stage = stages + (size_t)s * p.stage_bytes;
    if (first) out_next = walk.r0;
    // the output rows this band completes: out_next … out_end − 1
    const int out_end = min(walk.r1, max(out_next, done[i1]));
    mbar_wait(&bars[s], (kc / kStages) & 1);

    // 1. Convert the band, one pixel a thread: band pixel P (row ii, column x) sits at
    //    stage bytes pad + 3P … pad + 3P + 2 and lands as bf16 (r, g, b, 0) in slot
    //    ii·xf_stride + x. A band with bytes outside its copy (within 15 B of the
    //    frames' first or last byte) first has them written into the stage from device
    //    memory.
    const uint8_t* src = band_src(p, walk.img, i0);
    const int W = p.W3 / 3;
    const int nbytes = (i1 - i0) * p.W3;
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    const int pad = (int)(a & 15);
    int off0, off1;
    copied_range(p, a, (size_t)nbytes, off0, off1);
    if (off0 > pad || off1 < pad + nbytes) {  // uniform: only a tensor's edge bands
      for (int k = pad + tid; k < min(off0, pad + nbytes); k += kThreads)
        stage[k] = __ldg(src + (k - pad));
      for (int k = max(off1, pad) + tid; k < pad + nbytes; k += kThreads)
        stage[k] = __ldg(src + (k - pad));
      __syncthreads();
    }
    const float rcp_w = 1.0f / (float)W;
    for (int P = tid; P < (i1 - i0) * W; P += kThreads) {
      const int ii = __float2int_rz(((float)P + 0.5f) * rcp_w);  // P / W: P < 2²⁰
      const int b = pad + 3 * P;
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(stage + (b & ~3));
      const uint32_t v = __funnelshift_r(wp[0], wp[1], 8 * (b & 3));
      xf[P + ii * (p.xf_stride - W)] = bytes_to_bf16(v);
    }
    __syncthreads();
    if (tid == 0) {  // every thread is past this stage: refill it
      int j0, j1;
      bool f;
      if (prod.band(p, j0, j1, f)) {
        fence_async_shared();
        issue_band(p, stage, &bars[s], prod.img, j0, j1);
      }
    }

    // 2. Width pass: input rows i0 … i1 − 1 → ring slots i mod ring_rows, one 8-byte
    //    pixel load feeding the six sums of the thread's two columns.
    if (pair >= 0) {
      int slot = (i0 + wrow) % p.ring_rows;
      for (int i = i0 + wrow; i < i1; i += p.rows_par) {
        const uint2* win = xf + (i - i0) * p.xf_stride + px0;
        float a0[3] = {0.f, 0.f, 0.f}, a1[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < T + D; ++j) {
          const float4 v = bf16_to_f32(win[j]);
          if (j < T) {
            a0[0] = __fmaf_rn(w0[j], v.x, a0[0]);
            a0[1] = __fmaf_rn(w0[j], v.y, a0[1]);
            a0[2] = __fmaf_rn(w0[j], v.z, a0[2]);
          }
          a1[0] = __fmaf_rn(w1[j], v.x, a1[0]);
          a1[1] = __fmaf_rn(w1[j], v.y, a1[1]);
          a1[2] = __fmaf_rn(w1[j], v.z, a1[2]);
        }
        float2* arow = reinterpret_cast<float2*>(ring + (size_t)slot * p.S3p + 6 * pair);
        arow[0] = make_float2(quantize_u8(a0[0]), quantize_u8(a0[1]));
        if (second) {
          arow[1] = make_float2(quantize_u8(a0[2]), quantize_u8(a1[0]));
          arow[2] = make_float2(quantize_u8(a1[1]), quantize_u8(a1[2]));
        } else {
          reinterpret_cast<float*>(arow)[2] = quantize_u8(a0[2]);
        }
        slot += p.rows_par;
        while (slot >= p.ring_rows) slot -= p.ring_rows;
      }
    }
    __syncthreads();

    // 3. Height pass: every output row whose T input rows are in the ring.
    if (rsub < rows_par) {
      for (int r = out_next + rsub; r < out_end; r += rows_par) {
        float wr[T];
#pragma unroll
        for (int t = 0; t < T; ++t) wr[t] = htaps[r * T + t];
        int sl = hslot[r];
        float ua[4] = {0.f, 0.f, 0.f, 0.f}, ub[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const float4* ar = reinterpret_cast<const float4*>(ring + (size_t)sl * p.S3p + g * 8);
          const float4 va = ar[half], vb = ar[half ^ 1];
          ua[0] = __fmaf_rn(wr[t], va.x, ua[0]);
          ua[1] = __fmaf_rn(wr[t], va.y, ua[1]);
          ua[2] = __fmaf_rn(wr[t], va.z, ua[2]);
          ua[3] = __fmaf_rn(wr[t], va.w, ua[3]);
          ub[0] = __fmaf_rn(wr[t], vb.x, ub[0]);
          ub[1] = __fmaf_rn(wr[t], vb.y, ub[1]);
          ub[2] = __fmaf_rn(wr[t], vb.z, ub[2]);
          ub[3] = __fmaf_rn(wr[t], vb.w, ub[3]);
          sl = sl + 1 == p.ring_rows ? 0 : sl + 1;
        }
        float acc[8];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          acc[m] = half ? ub[m] : ua[m];
          acc[m + 4] = half ? ua[m] : ub[m];
        }
#pragma unroll
        for (int m = 0; m < 8; ++m)
          acc[m] = __fsub_rn(__fmul_rn(quantize_u8(acc[m]), inv[m]), sh[m]);
        const size_t o = ((size_t)walk.img * p.S + r) * p.S3 + g * 8;
        if (p.out_bf16) {
          __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.out) + o;
          if (vec_out) {
            uint4 v;
            uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const __nv_bfloat162 b2 = __floats2bfloat162_rn(acc[2 * m], acc[2 * m + 1]);
              w[m] = *reinterpret_cast<const uint32_t*>(&b2);
            }
            *reinterpret_cast<uint4*>(dst) = v;
          } else {
            for (int m = 0; m < 8 && g * 8 + m < p.S3; ++m) dst[m] = __float2bfloat16_rn(acc[m]);
          }
        } else {
          float* dst = static_cast<float*>(p.out) + o;
          if (vec_out) {
            reinterpret_cast<float4*>(dst)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
            reinterpret_cast<float4*>(dst)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
          } else {
            for (int m = 0; m < 8 && g * 8 + m < p.S3; ++m) dst[m] = acc[m];
          }
        }
      }
    }
    out_next = out_end;
  }
}

template <int T, int D>
cudaError_t launch(const PreParams& p, int grid, int smem, cudaStream_t stream) {
  static int opted_in[kMaxDevices] = {};  // shared memory already allowed, per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  auto kern = preprocess_kernel<T, D>;
  if (smem > opted_in[device]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in[device] = smem;
  }
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const PreParams& p, int taps, int grid, int smem, cudaStream_t s) {
  switch (taps) {
    case 4: return launch<4, D>(p, grid, smem, s);
    case 6: return launch<6, D>(p, grid, smem, s);
    case 12: return launch<12, D>(p, grid, smem, s);
    case 24: return launch<24, D>(p, grid, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface for ctypes. Returns a cudaError_t code: 0 on a clean launch. The
// host plan (ops/kernels/preprocess_kernel.py: tap_plan, work_items) sizes everything:
// taps T ∈ {4, 6, 12, 24} and pair gap D ∈ {2, 8} (the tables padded to them),
// the width pass's thread assignment and tap table, the band and ring rows, the stage
// size and converted-band stride and the shared memory they add up to, the chunks and
// the persistent grid.
extern "C" int ect_fused_preprocess(
    const void* x, void* out, const void* w_start, const void* h_start, const void* h_slot,
    const void* rows_done, const void* h_taps, const void* thread_pair, const void* thread_row,
    const void* thread_taps, int n, int H, int W, int S, int taps, int pair_gap,
    int rows_par, int xf_stride, int band_rows, int ring_rows, int chunks, int chunk_rows,
    int grid, int stage_bytes, int smem_bytes, int out_bf16, float inv0, float inv1,
    float inv2, float sh0, float sh1, float sh2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  PreParams p;
  p.x = static_cast<const uint8_t*>(x);
  p.x_end = p.x + (size_t)n * H * W * 3;
  p.out = out;
  p.w_start = static_cast<const int*>(w_start);
  p.h_start = static_cast<const int*>(h_start);
  p.h_slot = static_cast<const int*>(h_slot);
  p.rows_done = static_cast<const int*>(rows_done);
  p.h_taps = static_cast<const float*>(h_taps);
  p.thread_pair = static_cast<const int*>(thread_pair);
  p.thread_row = static_cast<const int*>(thread_row);
  p.thread_taps = static_cast<const float*>(thread_taps);
  p.H = H;
  p.W3 = W * 3;
  p.S = S;
  p.S3 = S * 3;
  p.S3p = (S * 3 + 7) / 8 * 8;
  p.rows_par = rows_par;
  p.xf_stride = xf_stride;
  p.band_rows = band_rows;
  p.ring_rows = ring_rows;
  p.chunks = chunks;
  p.chunk_rows = chunk_rows;
  p.items = n * chunks;
  p.stage_bytes = stage_bytes;
  p.out_bf16 = out_bf16;
  p.inv[0] = inv0, p.inv[1] = inv1, p.inv[2] = inv2;
  p.sh[0] = sh0, p.sh[1] = sh1, p.sh[2] = sh2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pair_gap == 2) return (int)launch_d<2>(p, taps, grid, smem_bytes, s);
  if (pair_gap == 8) return (int)launch_d<8>(p, taps, grid, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ect_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
