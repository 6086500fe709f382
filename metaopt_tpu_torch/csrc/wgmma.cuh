// Thin wrappers over the Hopper (sm_90a) PTX that the backward kernels K2 and
// K3 use: mbarriers, TMA tile loads (cp.async.bulk.tensor) and warpgroup
// matrix products (wgmma.mma_async) with their shared-memory descriptors.
//
// A warpgroup is the block's four warps. wgmma m64nNk16 (bf16 in, f32
// accumulate) leaves d (64 x N) spread over its 128 threads: warp w holds
// rows 16w..16w+15, and lane 4g + t holds, for each n8 column block j,
//   d[4j + 0], d[4j + 1] = (row 16w + g,     cols 8j + 2t, 8j + 2t + 1)
//   d[4j + 2], d[4j + 3] = (row 16w + g + 8, cols 8j + 2t, 8j + 2t + 1)
// which is mma.sync m16n8k16's C fragment per warp and n8 block. A taken
// from registers is m16n8k16's A fragment of each warp's 16 rows (see
// warp_mma.cuh), so an accumulator rounded to bf16 feeds the next product
// from registers, as with mma.sync.
//
// Operands in shared memory are the tiles TMA writes: 64 rows of one
// (batch, head) slice, cut into panels of P columns (P = 64 bf16 = 128
// bytes a row, swizzled 128B; P = 32 for D = 32, swizzled 64B), each
// panel 64 rows x P, the panels one after another. A descriptor reads such
// a tile either K-major (the product's k runs along the row: S = Q K^T)
// or MN-major (k runs down the rows: dV += P^T dO reads dO that way).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "warp_mma.cuh"

// ---------------------------------------------------------------------------
// mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
                 : "memory");
}

// Makes the initialized barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` more to land by TMA.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_addr(bar)), "r"(parity)
            : "memory");
    } while (!done);
}

// Orders this thread's generic-proxy shared-memory accesses after the
// async proxy's (TMA writes, wgmma reads) to the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// TMA: one box of a 4-D tensor map into shared memory, completing on `bar`.
// Coordinates are innermost first; boxes past the tensor's edge are zero.

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3)
        : "memory");
}

// ---------------------------------------------------------------------------
// wgmma

// Rows of every tile TMA writes.
constexpr int kTileRows = 64;

// Columns of one panel of a D-wide tile, and its swizzle (the descriptor's
// layout type: 1 = 128B, 2 = 64B).
template <int D> __host__ __device__ constexpr int panel_cols() { return D >= 64 ? 64 : 32; }
template <int D> __host__ __device__ constexpr uint64_t panel_swizzle() {
    return D >= 64 ? 1 : 2;
}

__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
           (uint64_t)(sbo >> 4) << 32 | layout << 62;
}

// Operand of a product whose k runs along the rows of a D-wide tile: rows
// 0..63, columns 16 kk..16 kk + 15 (K-major; 8-row groups 8 P x 2 bytes apart).
template <int D>
__device__ __forceinline__ uint64_t desc_k(const void* tile, int kk) {
    constexpr int P = panel_cols<D>();
    const int col = kk * 16;
    return gmma_desc(smem_addr(tile) + (col / P) * (kTileRows * P * 2) + (col % P) * 2, 16,
                     8 * P * 2, panel_swizzle<D>());
}

// Operand of a product whose k runs down the rows: rows 16 kk..16 kk + 15,
// all D columns (MN-major; panels 64 P x 2 bytes apart, 8-row groups 8 P x 2).
template <int D>
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int kk) {
    constexpr int P = panel_cols<D>();
    return gmma_desc(smem_addr(tile) + kk * 16 * P * 2, kTileRows * P * 2, 8 * P * 2,
                     panel_swizzle<D>());
}

// Make the registers this thread wrote visible to the next wgmma.
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

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across its issue or its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// m64nNk16 with bf16 operands and f32 accumulators: `ss` reads A and B from
// shared memory (both K-major), `rs` takes A from registers and reads B
// MN-major. scale-d is 1: every call adds to d.

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x N) += A (registers) B (MN-major), N = 32, 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
    if constexpr (N == 32) wgmma_rs_n32(d, a, db);
    else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
    else wgmma_rs_n128(d, a, db);
}
