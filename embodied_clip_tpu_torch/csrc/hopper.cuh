// Hopper building blocks shared by the port's TMA + wgmma kernels
// (bottleneck_bf16.cu: K6/K7; bottleneck_int8.cu: K3-K5 and the stride blocks;
// stem_int8.cu: K2; preprocess.cu: K1): mbarriers, 1-D bulk copies, TMA loads and stores,
// ldmatrix, wgmma (operands in shared memory, or A in registers; the bf16 32-k groups
// summed in fresh registers and promoted with IEEE adds that K6/K7 and the stride
// shortcut share), its fences and shared-memory descriptors on the device; the tensor-map encoders
// (cuTensorMapEncodeTiled / Im2col) on the host. Each source that includes it is its own
// library, so the anonymous namespace gives each its own copy.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------------------ device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni LAB_DONE;\nbra.uni LAB_WAIT;\nLAB_DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` contiguous bytes from global `src` to shared `dst` (the 1-D bulk copy, no
// tensor map), completing on `bar`'s transaction count. dst, src and bytes are
// multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The box of output pixels × channels of the 3×3 tap (kx, ky), starting at the pixel
// whose top-left input neighbour is (w, h) of image n (im2col mode; the box walks W,
// then H, then N, and zero-fills what lies outside the image and past C).
__device__ __forceinline__ void tma_load_im2col(void* dst, const CUtensorMap* map,
                                                uint64_t* bar, int c, int w, int h, int n,
                                                uint16_t kx, uint16_t ky) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(w), "r"(h),
      "r"(n), "h"(kx), "h"(ky)
      : "memory");
}

// The box at (c0, c1, c2, c3) of a 4-D tensor map (an NHWC patch: channels, W, H, image).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::
                   "l"(reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's generic-proxy shared-memory writes visible to the async proxy
// (TMA stores, wgmma operand reads).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15) over THREADS threads (whole warps).
template <int THREADS = 128>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
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

// Keep the compiler from moving reads or writes of wgmma registers across the wgmma
// fences and waits (the asm statements do not name them).
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(int (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Four 8 × 8 b16 matrices from shared memory: lane l gives the address of row l % 8 of
// matrix l / 8 (16 bytes), and register i of every lane receives its part of matrix i.
// With lanes 0-15 on rows 0-15 at k 0 and lanes 16-31 on rows 0-15 at k 8, the four
// registers are a 16 × 16 A fragment of wgmma's register form.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += A (64 × 16 bf16, from registers: warp w of the warpgroup holds rows 16w … 16w + 15
// as ldmatrix_x4 gives them) · B (16 × N bf16, shared-memory descriptor b; TRANS_B 0:
// K-major, 1: N-major), f32 accumulators in wgmma's register layout.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1), "n"(TRANS_B));
}

template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 16 || N == 64 || N == 96 || N == 128, "no register-A wgmma of this width");
  if constexpr (N == 16)
    wgmma_rs_n16<TRANS_B>(d, a, b);
  else if constexpr (N == 64)
    wgmma_rs_n64<TRANS_B>(d, a, b);
  else if constexpr (N == 96)
    wgmma_rs_n96<TRANS_B>(d, a, b);
  else
    wgmma_rs_n128<TRANS_B>(d, a, b);
}

// d (+)= A (64 × 16, K-major) · B (16 × n, N-major), bf16 in, f32 out. ACC: add to d;
// otherwise overwrite it (write-only operands: the old d is dead).
template <bool ACC>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b) {
  if constexpr (ACC)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "n"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        :
          "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
          "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
          "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
        : "l"(a), "l"(b), "n"(0));
}

template <bool ACC>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b) {
  if constexpr (ACC)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "n"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        :
          "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
          "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
          "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
          "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
          "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
          "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
          "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
        : "l"(a), "l"(b), "n"(0));
}

template <int BN, bool ACC>
__device__ __forceinline__ void wgmma_k16(float (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 128)
    wgmma_n128<ACC>(d, a, b);
  else
    wgmma_n64<ACC>(d, a, b);
}

// One 32-k group (k16 steps 2g, 2g + 1 of a 64-k chunk) into fresh registers d: the
// first step overwrites d. A advances 32 B per k16 step within its swizzle row, B 16 rows.
template <int BN>
__device__ __forceinline__ void wgmma_group(float (&d)[BN / 2], uint64_t a, uint64_t b, int g) {
  wgmma_fence();
  wgmma_k16<BN, false>(d, a + 4 * g, b + 256 * g);
  wgmma_k16<BN, true>(d, a + 4 * g + 2, b + 256 * g + 128);
  wgmma_commit();
}

// acc += d with IEEE adds, in register order (a 32-k group's sum into the running sum).
template <int R>
__device__ __forceinline__ void promote(float (&acc)[R], float (&d)[R]) {
  fence_regs(d);
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
}

// Shared-memory matrix descriptor, 128-byte swizzle. A K-major operand: sbo = 1024 B
// between 8-row groups (lbo unused). An N-major one: lbo = the stride between
// 64-column panels, sbo = 1024 B between 8-k-row groups. The start address advances in
// 16-byte units: +2 per 32 bytes of k within a swizzle row.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// ------------------------------------------------------------------------- host side

PFN_cuTensorMapEncodeTiled_v12000 encode_tiled = nullptr;
PFN_cuTensorMapEncodeIm2col_v12000 encode_im2col = nullptr;
int driver_version = 0;

constexpr int kEncodeFailed = 10000;  // + CUresult: a tensor map was refused
constexpr int kMaxDevices = 64;

inline cudaError_t load_driver_entry_points() {
  if (encode_tiled && encode_im2col) return cudaSuccess;
  cudaDriverEntryPointQueryResult q;
  void* fn = nullptr;
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
  if (err != cudaSuccess) return err;
  if (q != cudaDriverEntryPointSuccess || !fn) return cudaErrorNotSupported;
  encode_tiled = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  err = cudaGetDriverEntryPoint("cuTensorMapEncodeIm2col", &fn, cudaEnableDefault, &q);
  if (err != cudaSuccess) return err;
  if (q != cudaDriverEntryPointSuccess || !fn) return cudaErrorNotSupported;
  encode_im2col = reinterpret_cast<PFN_cuTensorMapEncodeIm2col_v12000>(fn);
  return cudaDriverGetVersion(&driver_version);
}

// Set the device, load the tensor-map encoders and read the device's SM count (cached).
inline cudaError_t prepare_launch(int device, int* sms) {
  static int cached[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = load_driver_entry_points();
  if (err == cudaSuccess && !cached[device])
    err = cudaDeviceGetAttribute(&cached[device], cudaDevAttrMultiProcessorCount, device);
  *sms = cached[device];
  return err;
}

// A row-major (rows, cols) matrix of `elem`-byte elements, loaded or stored as
// box_cols × box_rows boxes (box_cols · elem ≤ 128), 128-byte swizzled; out-of-bounds
// elements read as zero and are not written.
inline CUresult encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem,
                          const void* ptr, int rows, int cols, int box_cols, int box_rows) {
  const cuuint64_t dim[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return encode_tiled(map, type, 2, const_cast<void*>(ptr), dim, stride, box, estr,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// NHWC (n, H, W, C) in im2col mode for the 3×3 'SAME' convolution: `pixels` output
// pixels × `channels` channels per load, the pixel box from -1 to -1 on W and H (so a
// load starting at output pixel (y, x) names input (x - 1, y - 1), and the filter tap
// is the load's offset).
inline CUresult encode_3x3_im2col(CUtensorMap* map, CUtensorMapDataType type, int elem,
                                  const void* ptr, int n, int H, int W, int C, int channels,
                                  int pixels) {
  const cuuint64_t dim[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                             static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(n)};
  const cuuint64_t stride[3] = {static_cast<cuuint64_t>(C) * elem,
                                static_cast<cuuint64_t>(W) * C * elem,
                                static_cast<cuuint64_t>(H) * W * C * elem};
  const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = encode_im2col(map, type, 4, const_cast<void*>(ptr), dim, stride, lower, upper,
                             channels, pixels, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  // Drivers up to 13.1 mishandle im2col maps of tensors under 128 KB unless this bit of
  // the descriptor is cleared (the same workaround as CUTLASS's
  // cute/atom/copy_traits_sm90_im2col.hpp).
  if (r == CUDA_SUCCESS && driver_version <= 13010 &&
      static_cast<uint64_t>(n) * H * W * C * elem < 131072)
    reinterpret_cast<uint64_t*>(map)[1] &= ~(1ull << 21);
  return r;
}

// NHWC (n, H, W, C) loaded as boxes of box_c channels × box_w × box_h pixels of one
// image, unswizzled: pixel (y, x) of a box lands at (y · box_w + x) · box_c · elem bytes.
// Out-of-bounds pixels and channels past C read as zero, so a box may start at -1 ('SAME'
// padding) and box_c > C pads each pixel.
inline CUresult encode_nhwc_patch(CUtensorMap* map, CUtensorMapDataType type, int elem,
                                  const void* ptr, int n, int H, int W, int C, int box_c,
                                  int box_w, int box_h) {
  const cuuint64_t dim[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                             static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(n)};
  const cuuint64_t stride[3] = {static_cast<cuuint64_t>(C) * elem,
                                static_cast<cuuint64_t>(W) * C * elem,
                                static_cast<cuuint64_t>(H) * W * C * elem};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_c), static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_h), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode_tiled(map, type, 4, const_cast<void*>(ptr), dim, stride, box, estr,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace
