// Fused multi-head self-attention of the CLIP transformer blocks, bf16 in and out:
// softmax(q kᵀ / √64) v for every head of a (N, T, 3C) in-projection output, written as
// the (N, T, C) input of the out-projection.
//
// Replaces no TPU kernel: the JAX package leaves attention to XLA
// (`embodied_clip_tpu/models/transformer.py:attention_core`). The port's plain route
// (`models/transformer.attention_core`) materialises f32 logits of N·H·T² values and reads
// and writes them in five passes; at ViT-L/14@336px's batch 128 (T = 577, 16 heads) that
// is 2.73 GB of logits a layer, against 0.60 GB of q, k, v and output. Here the logits and
// probabilities never leave registers (the online softmax of FlashAttention).
//
// Bound: per layer and frame 4·T²·C operations on the tensor cores (the two products)
// and 4·T·C bf16 values of device memory (q, k, v read once, the output written once).
// At T = 577, C = 1024 the work is 288 operations a byte, at the H100's bf16 ridge (295):
// neither bound leaves room for a second pass over memory. Beside the products each logit
// costs one exponential (MUFU, 16 a clock an SM) and about six f32 operations, which at
// head dim 64 take about as long as its 128 multiply-adds on the tensor cores.
//
// Design: warpgroup `wgmma` with both A operands in registers.
// - A block holds 128 query rows of one (frame, head): two warpgroups of 64 rows (wgmma's
//   M). Each keeps its 64 × 64 q tile as A fragments in registers for the whole pass
//   (loaded once by ldmatrix). s = q kᵀ is m64n64k16 with k from shared memory (K-major
//   B); the probabilities go from the s accumulators straight into the A fragments of
//   o += bf16(p) v (the m64nN accumulator layout is the A register layout), with v from
//   shared memory (N-major B). 118 registers: two blocks (16 warps) share an SM, and one
//   warpgroup's softmax runs while another's products do.
// - k and v are walked in tiles of 64 keys, double-buffered by cp.async (the next tile's
//   copy in flight under this one's work), into 128-byte rows whose 16-byte chunks are
//   XOR-swizzled by row: the 128-byte swizzle that the wgmma descriptors and ldmatrix
//   read without bank conflicts (the tiles start on 1024-byte boundaries).
// - Blocks are numbered with the query tile fastest, so the 5 blocks of one (frame, head)
//   at T = 577 run together and read its k and v (148 KB) from L2 after the first.
// - Measured on an H100 at batch 128, T = 577, a layer (PERF.md §6): warp-level
//   mma.sync with 16 rows a warp 0.96 ms (ldmatrix's shared-memory traffic as long as the
//   products), 32 rows a warp 0.79-0.86, this design 0.70; the same with three k/v
//   stages and s of the next tile issued under this tile's softmax (one block an SM, 166
//   registers) 1.15.
// - Arithmetic (the port's precision policy, `models/transformer.py`): the logits are
//   f32 sums of bf16 products; the running row maximum and row sum are f32; keys at or
//   past T are -inf. The probabilities are exp((s - m) / 8) in f32, computed as
//   exp2((s - m) · log2(e)/8) (the scale 1/8 is exact; the folded constant moves the
//   exponent's argument by an f32 rounding, ~1e-7 relative, against bf16's 2^-9), rounded
//   to bf16 for the p·v product (f32 accumulation), and the output is the f32 sum over the
//   f32 row sum, rounded to bf16. `ops/kernels/attention_kernel.attention_plain` is the
//   same tiling and roundings in torch.
// - Ragged edges: a warpgroup whose 64 rows all lie at or past T issues nothing; in the
//   last key tile, 16 keys or fewer are issued as m64n16k16 and p·v only in the 16-key
//   steps that hold a key below T (`issued_macs` in the wrapper counts the same tiles).
//   Out-of-range rows are zero-filled on load and not stored.
//
// Head dim 64, any T ≥ 1, no mask. The C interface takes the in-projection output as it
// lies: row stride 3C, q at column 64h, k at C + 64h, v at 2C + 64h.

#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kRows = 128;
constexpr int kKeys = 64;
constexpr int kThreads = 256;
constexpr int kRowBytes = 128;
constexpr int kQBytes = kRows * kRowBytes;
constexpr int kKVBytes = kKeys * kRowBytes;
constexpr int kSmem = kQBytes + 4 * kKVBytes + 1024;   // + alignment to 1024 B
constexpr float kLog2eOver8 = 1.4426950408889634f * 0.125f;
constexpr int kBadShape = 9001;

__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * kRowBytes + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 128-byte-swizzled shared-memory descriptor of a tile at shared address `addr`
// (1024-byte aligned atoms of 8 rows × 128 B): sbo 1024 B between 8-row groups; lbo
// (between 64-column panels) is unused, the tiles being 64 columns wide.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(8192 >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

// d (+)= a (64 × 16 bf16 from registers: warp w of the warpgroup holds rows 16w … 16w + 15
// as ldmatrix_x4 gives them) · b (16 × 64 bf16, descriptor; TB 0: K-major, 1: N-major).
template <int TB, bool ACC>
__device__ __forceinline__ void wgmma64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(ACC ? 1 : 0), "n"(TB));
}

// The same with b 16 × 16 (a last key tile of 16 keys or fewer).
template <int TB, bool ACC>
__device__ __forceinline__ void wgmma16(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(ACC ? 1 : 0), "n"(TB));
}

// `ROWS` rows of a 64-wide head slice (row stride `stride` elements) from global row
// `row0` into a swizzled tile; rows at or past `t` are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* base, int row0,
                                          int t, int stride) {
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7;
    const bool valid = row0 + r < t;
    const __nv_bfloat16* src = base + (size_t)(valid ? row0 + r : 0) * stride + c * 8;
    cp_async16(dst + swz(r, c), src, valid);
  }
}

// One key tile for one warpgroup's 64 rows. NG: 8-key groups issued (8, or 2 for a last
// tile of 16 keys or fewer); LAST: mask keys at or past `keys`, and issue only the p·v
// steps that hold one.
template <int NG, bool LAST>
__device__ __forceinline__ void key_tile(const uint32_t (&qf)[4][4], uint32_t k_s, uint32_t v_s,
                                         int keys, float (&o)[32], float (&m)[2], float (&l)[2],
                                         int lane) {
  float s[NG * 4];
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if constexpr (NG == 8) {
      if (ks == 0) wgmma64<0, false>(s, qf[ks], desc(k_s) + 2 * ks);
      else wgmma64<0, true>(s, qf[ks], desc(k_s) + 2 * ks);
    } else {
      if (ks == 0) wgmma16<0, false>(s, qf[ks], desc(k_s) + 2 * ks);
      else wgmma16<0, true>(s, qf[ks], desc(k_s) + 2 * ks);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  const int t4 = lane & 3;
  if (LAST) {
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int key = 8 * j + 2 * t4;
      if (key >= keys) s[4 * j] = s[4 * j + 2] = -INFINITY;
      if (key + 1 >= keys) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float alpha[2], ms[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = ex2((m[h] - mx[h]) * kLog2eOver8);
    ms[h] = mx[h] * kLog2eOver8;
    m[h] = mx[h];
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], kLog2eOver8, -ms[0]));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], kLog2eOver8, -ms[0]));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], kLog2eOver8, -ms[1]));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], kLog2eOver8, -ms[1]));
    l[0] += s[4 * j] + s[4 * j + 1];
    l[1] += s[4 * j + 2] + s[4 * j + 3];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
  uint32_t p[NG / 2][4];
#pragma unroll
  for (int kk = 0; kk < NG / 2; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NG / 2; ++kk) {
    if (LAST && 16 * kk >= keys) break;
    wgmma64<1, true>(o, p[kk], desc(v_s) + 128 * kk);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

__global__ void __launch_bounds__(kThreads, 2)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                      int t, int heads, int q_tiles) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s0 = q_s + kQBytes, v_s0 = k_s0 + 2 * kKVBytes;

  const int qt = blockIdx.x % q_tiles;
  const int nh = blockIdx.x / q_tiles;
  const int n = nh / heads, h = nh % heads;
  const int c = heads * kHeadDim, stride = 3 * c;
  const __nv_bfloat16* q_g = qkv + (size_t)n * t * stride + h * kHeadDim;
  const __nv_bfloat16* k_g = q_g + c;
  const __nv_bfloat16* v_g = q_g + 2 * c;
  const int q0 = qt * kRows;
  const int kv_tiles = (t + kKeys - 1) / kKeys;

  load_tile<kRows>(q_s, q_g, q0, t, stride);
  cp_async_commit();
  load_tile<kKeys>(k_s0, k_g, 0, t, stride);
  load_tile<kKeys>(v_s0, v_g, 0, t, stride);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3;   // warpgroup, and warp within it
  const int mi = lane >> 3, r8 = lane & 7;
  const bool active = q0 + 64 * wg < t;   // a warpgroup of padded rows issues nothing

  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldmatrix_x4(qf[ks], q_s + swz(64 * wg + 16 * wq + r8 + 8 * (mi & 1), 2 * ks + (mi >> 1)));

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < kv_tiles; ++j) {
    if (j + 1 < kv_tiles) {
      const int st = (j + 1) & 1;
      load_tile<kKeys>(k_s0 + st * kKVBytes, k_g, (j + 1) * kKeys, t, stride);
      load_tile<kKeys>(v_s0 + st * kKVBytes, v_g, (j + 1) * kKeys, t, stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    const uint32_t k_s = k_s0 + (j & 1) * kKVBytes, v_s = v_s0 + (j & 1) * kKVBytes;
    if (active) {
      const int keys = t - j * kKeys;
      if (j + 1 < kv_tiles)
        key_tile<8, false>(qf, k_s, v_s, kKeys, o, m, l, lane);
      else if (keys <= 16)
        key_tile<2, true>(qf, k_s, v_s, keys, o, m, l, lane);
      else
        key_tile<8, true>(qf, k_s, v_s, keys, o, m, l, lane);
    }
    __syncthreads();
  }

  // Row sums over the quad, o / l in f32, rounded to bf16 and staged in the q tile's
  // shared memory, then stored 16 bytes a thread.
  const int g = lane >> 2, t4 = lane & 3;
  if (active) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sum = l[hh];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = 64 * wg + 16 * wq + g + 8 * hh;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const uint32_t v = pack_bf16(o[4 * jj + 2 * hh] / sum, o[4 * jj + 2 * hh + 1] / sum);
        asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(q_s + swz(row, jj) + 4 * t4), "r"(v)
                     : "memory");
      }
    }
  }
  __syncthreads();
  __nv_bfloat16* o_g = out + (size_t)n * t * c + h * kHeadDim;
#pragma unroll
  for (int i = threadIdx.x; i < kRows * 8; i += kThreads) {
    const int r = i >> 3, ch = i & 7;
    if (q0 + r >= t) continue;
    uint4 v;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(q_s + swz(r, ch)));
    *reinterpret_cast<uint4*>(o_g + (size_t)(q0 + r) * c + ch * 8) = v;
  }
}

}  // namespace

// qkv (n, t, 3 · heads · 64) bf16, contiguous and 16-byte aligned → out (n, t, heads · 64)
// bf16. Returns a cudaError_t, or kBadShape.
extern "C" int ect_attention_bf16(const void* qkv, void* out, int n, int t, int heads,
                                  int device, void* stream) {
  if (n < 0 || t < 0 || heads <= 0) return kBadShape;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0 || t == 0) return 0;
  const int q_tiles = (t + kRows - 1) / kRows;
  const long long blocks = (long long)q_tiles * n * heads;
  if (blocks > 0x7fffffffLL) return kBadShape;
  static bool configured[64] = {};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!configured[device]) {
    err = cudaFuncSetAttribute(attention_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    configured[device] = true;
  }
  attention_bf16_kernel<<<(unsigned)blocks, kThreads, kSmem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), t, heads,
      q_tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* ect_error_string(int code) {
  if (code == kBadShape)
    return "attention: n, t ≥ 0 and heads > 0, with n · heads · ⌈t/128⌉ below 2^31";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
