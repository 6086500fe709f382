// Thin wrappers over the PTX instructions the tensor-core kernels use:
// cp.async (16-byte global -> shared copies), ldmatrix (8x8 b16 matrices
// from shared memory into mma fragments) and mma.sync m16n8k16 (bf16 in,
// f32 accumulate). Available on sm_80 and later, so on sm_90a.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4; each 32-bit register holds two bf16, the lower column in
// the lower half):
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..),
//                           a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..)
//   B (16 x 8, k x n):      b0 = (k 2t..2t+1, n g), b1 = (k 2t + 8.., n g)
//   C (16 x 8, f32):        c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, 2t..)
// So the C tiles of two neighbouring n8 columns are, rounded to bf16, the
// A fragment of one 16-wide k slice: a product's result feeds the next
// product from registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from device memory to shared memory without passing through
// registers; with bytes == 0 the 16 shared bytes are zero-filled instead.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and each lane receives (row g, cols 2t..2t+1) of every matrix.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// As ldsm_x4, transposed: each lane receives (rows 2t..2t+1, col g).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// c += a * b for one 16x8x16 tile.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// (lo, hi) as two bf16 pairs, head + tail, whose sum carries 16 bits of
// mantissa: a product of head and tail with a bf16 operand is exact to
// about 2^-17 of each term instead of 2^-9.
__device__ __forceinline__ void pack_bf16_split(float lo, float hi, uint32_t& head,
                                                uint32_t& tail) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    head = *reinterpret_cast<const uint32_t*>(&v);
    tail = pack_bf16(lo - __low2float(v), hi - __high2float(v));
}
