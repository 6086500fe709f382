// Flash attention for the demo Transformer and the LM, written for Hopper
// (sm_90a).
//
// Replaces the three Pallas TPU kernels of metaopt_tpu/ops/attention.py:
//   flash_fwd_kernel_mma      <- _flash_fwd_kernel     (:77, launched at :159), bf16
//   flash_bwd_dkv_kernel_mma  <- _flash_bwd_dkv_kernel (:181, pass 1 of _pallas_backward,
//                                launched at :321), bf16
//   flash_bwd_dq_kernel_mma   <- _flash_bwd_dq_kernel  (:238, pass 2, launched at :358), bf16
//   flash_fwd_kernel, flash_bwd_dkv_kernel, flash_bwd_dq_kernel: the same for f32
// and, inside all six, the attention dropout that the reference runs in its
// XLA chunked twin (_chunked_forward / _chunked_backward with _dropout_tile),
// drawn in registers (see Dropout below).
//
// What bounds them on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense), counting
// each input read once, each output written once and the products over the
// (query, key) pairs the mask keeps (chip_smoke.py computes these bounds):
//   - the slice's shape (B 32, S 64, H 8, D 64, padding mask): 8-13 MB a
//     call, bound by bytes: K1 2.5 us, K2 3.8 us, K3 3.2 us;
//   - the long shape (B 8, S 512, H 8, D 64, causal): still by bytes, K2
//     8.2 us, K3 7.0 us, K1 5.7 us; the causal pairs' products alone would
//     take K2 4.4 us;
//   - the LM's shape (B 32, S 512, H 8, D 64, causal in memory, dropout
//     0.1): by bytes, K1 22.7 us, K2 32.9 us, K3 27.9 us. Philox's integer
//     rounds are outside both bounds.
//
// Common design: the (Sq, Sk) score matrix never reaches device memory.
// Each block owns a 64-row tile of one (batch, head), streams 64-row tiles
// of the other axis through shared memory and keeps its accumulators on
// chip; tensors are read straight from the (B, S, H, D) layout through
// strides, so no transposed or padded copies are made.
//
// In bf16 all three run on the tensor cores with four warps (one
// warpgroup) of 16 owned rows each. K1 is FlashAttention-2 style: tiles
// copied to shared memory with cp.async, two stages so the next tile's copy
// overlaps this tile's math, every product mma.sync m16n8k16 fed by
// ldmatrix, P kept in registers, where its accumulator layout is the next
// product's A fragment; K tiles whose keep flags are all zero for the
// block's Q tile are skipped (__syncthreads_or). K2 and K3 are built for
// long causal sequences with dropout, where the LM runs them six times a
// step (see "K2 and K3 for bf16 inputs" below): a live-tile list built
// before the loop, so a dead tile pair (28 of the 64 of a causal 512 x 512
// mask) is never copied, multiplied or drawn for; one Philox call per four
// elements, shared across lanes by shuffles; and every product a wgmma on
// 128B-swizzled tiles that TMA fills into a two-stage mbarrier ring, with P
// and dS fed back from registers. At S = 64 a block does one tile step, and
// registers (see ptxas -v) let two or more blocks share an SM, so the
// slice's 256 blocks are resident in one wave on 132 SMs.
//
// f32 stays on the CUDA cores (scalar f32 FMAs from f32 tiles in shared
// memory): f32 attention is off the Transformer's path and held to 1e-5
// forward and 1e-4 for gradients, which bf16 operands cannot meet.
//
// Semantics kept from the Pallas bodies:
//   - q arrives pre-scaled; softmax statistics and accumulators are f32;
//   - the optional int8 mask is per batch, shared by the heads (bh / H),
//     and is read through its strides (a broadcast mask needs no copy);
//   - masked scores are -1e30 and the running max is floored at -5e29, so
//     a fully masked tile contributes exactly zero;
//   - O = acc / max(l, 1e-30), lse = m + log(l), and lse = +inf where l == 0;
//   - the backward recomputes p = exp(s - lse) (p == 0 on fully masked
//     rows) and ds = p * (dO.V^T - delta), delta = rowsum(dO * O) given;
//   - rows and columns past Sq or Sk behave as the padded, masked tails of
//     _block_and_pad: they contribute nothing and are not written;
//   - two passes for the backward: dK/dV owned by one block per K tile,
//     dQ by one block per Q tile, no atomics, so results are deterministic.
// On the tensor cores P is rounded to bf16 as an operand of dV = P^T dO,
// as a TPU's default-precision f32 dot would round it. dS for dK and dQ,
// and P for O = P V, are split into two bf16 terms (head + tail) whose sum
// keeps 16 bits: dS's rows sum to zero, so dQ = dS K cancels, and a
// rounding of 2^-9 per term of dS, or of P (which moves O, and through
// delta = rowsum(dO * O) every dS), leaves dQ outside the bf16 bound.
//
// Each entry point returns cudaGetLastError() after its launch, or, for K2
// and K3 in bf16, kMapError (+ the driver's CUresult) where no TMA tensor
// map could be made of its tensors.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <chrono>
#include <type_traits>

#include "warp_mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;           // 64 rows x 4 threads per row
constexpr int kRows = 64;               // rows of the tile a block owns
constexpr int kCols = 64;               // rows of the tile streamed per step
constexpr int kTpr = 4;                 // threads per owned row
constexpr float kNegBig = -1e30f;

// Copy rows [row0, row0 + rows) of one (batch, head) slice into shared
// memory as f32 with a padded leading dimension; rows past n are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long row_stride,
                                          int row0, int n, int rows) {
    constexpr int LD = D + 1;
    for (int i = threadIdx.x; i < rows * D; i += kThreads) {
        const int r = i / D, c = i - r * D;
        const int g = row0 + r;
        dst[r * LD + c] = g < n ? src[(long long)g * row_stride + c] : 0.f;
    }
}

template <int D>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
    float s = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
    return s;
}

__device__ __forceinline__ float group_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float group_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// Attention dropout, drawn in registers. The keep bit of element (b*h, row,
// col) is word col % 4 of Philox4x32-10 (Random123) on the counter (col / 4,
// row, b*h, offset) with the 64-bit seed as its key: the element is kept
// when that word is below keep_prob * 2^32, and a kept probability is
// scaled by 1 / keep_prob. K1, K2 and K3 draw the same bit for the same
// element, so the backward replays the forward's mask and no mask is
// stored; ops/attention.py::philox_keep draws the same bits on the host.
// Each kernel takes the dropout as a template flag: without it (rate 0)
// it compiles to the code it had before dropout existed. With it, Philox's
// ten rounds (~75 integer instructions a call) are ALU work outside the
// byte and tensor-core bounds: K1 makes one call per two elements (a
// thread's fragment holds column pairs); K2 and K3 one per four, the lanes
// that hold a call's four columns sharing it by shuffles (dkv_keep_bits,
// dq_keep_bits); chip_smoke.py times each against rate 0.
struct Dropout {
    uint32_t k0, k1, offset;
    unsigned long long thr;  // keep when the word is below this
    float scale;             // 1 / keep_prob
};

Dropout make_dropout(float rate, unsigned long long seed, unsigned long long offset) {
    const float keep = 1.f - rate;
    Dropout dr;
    dr.k0 = (uint32_t)seed;
    dr.k1 = (uint32_t)(seed >> 32);
    dr.offset = (uint32_t)offset;
    dr.thr = (unsigned long long)((double)keep * 4294967296.0);
    dr.scale = 1.f / keep;
    return dr;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        if (r > 0) {
            k0 += 0x9E3779B9u;
            k1 += 0xBB67AE85u;
        }
        const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
        const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
        c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    }
    return c;
}

__device__ __forceinline__ uint4 philox_words(const Dropout& dr, int bh, int row, int col) {
    return philox4x32_10(
        make_uint4((uint32_t)col >> 2, (uint32_t)row, (uint32_t)bh, dr.offset), dr.k0, dr.k1);
}

__device__ __forceinline__ bool keep_bit(const Dropout& dr, int bh, int row, int col) {
    const uint4 w = philox_words(dr, bh, row, col);
    const int i = col & 3;
    return (i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w) < dr.thr;
}

// The keep bits of (row, col) and (row, col + 1) for an even col: both
// words come from one Philox call.
__device__ __forceinline__ void keep_pair(const Dropout& dr, int bh, int row, int col, bool& a,
                                          bool& b) {
    const uint4 w = philox_words(dr, bh, row, col);
    const bool hi = (col & 2) != 0;
    a = (hi ? w.z : w.x) < dr.thr;
    b = (hi ? w.w : w.y) < dr.thr;
}

__device__ __forceinline__ float dropped(bool keep, float x, const Dropout& dr) {
    return keep ? x * dr.scale : 0.f;
}

// ---------------------------------------------------------------------------
// K1: forward. One block per (b*h, 64-row Q tile); K/V tiles stream through.

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int8_t* __restrict__ mask,
                 float* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Sk,
                 long long msb, long long msq, long long msk, Dropout dr) {
    constexpr int LD = D + 1, LP = kCols + 1, NC = D / kTpr, NS = kCols / kTpr;
    extern __shared__ float smem[];
    float* sQ = smem;
    float* sK = sQ + kRows * LD;
    float* sV = sK + kCols * LD;
    float* sP = sV + kCols * LD;

    const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
    const int q0 = blockIdx.y * kRows;
    const int r = threadIdx.x / kTpr, sub = threadIdx.x % kTpr;
    const int qi = q0 + r;
    const long long rs = (long long)H * D;
    const float* qb = q + (long long)b * Sq * rs + (long long)h * D;
    const float* kb = k + (long long)b * Sk * rs + (long long)h * D;
    const float* vb = v + (long long)b * Sk * rs + (long long)h * D;
    const int8_t* mrow = mask ? mask + b * msb + (long long)min(qi, Sq - 1) * msq : nullptr;

    load_tile<D>(sQ, qb, rs, q0, Sq, kRows);

    float m = -INFINITY, l = 0.f, acc[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] = 0.f;

    for (int k0 = 0; k0 < Sk; k0 += kCols) {
        __syncthreads();  // everyone is done with the previous K/V tile
        load_tile<D>(sK, kb, rs, k0, Sk, kCols);
        load_tile<D>(sV, vb, rs, k0, Sk, kCols);
        __syncthreads();

        float s[NS], mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            const int c = sub + kTpr * j, kc = k0 + c;
            const float dotv = dot_rows<D>(sQ + r * LD, sK + c * LD);
            const bool keep = kc < Sk && (mrow == nullptr || mrow[kc * msk] != 0);
            s[j] = keep ? dotv : kNegBig;
            mx = fmaxf(mx, s[j]);
        }
        mx = group_max(mx);
        const float m_new = fmaxf(fmaxf(m, mx), 0.5f * kNegBig);
        const float alpha = expf(m - m_new);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            float p = expf(s[j] - m_new);
            psum += p;  // l sums the probabilities before dropout
            if constexpr (kDrop) p = dropped(keep_bit(dr, bh, qi, k0 + sub + kTpr * j), p, dr);
            sP[r * LP + sub + kTpr * j] = p;
        }
        l = alpha * l + group_sum(psum);
        m = m_new;
        __syncwarp();  // the four threads of a row share a warp
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[j] *= alpha;
        for (int kk = 0; kk < kCols; ++kk) {
            const float p = sP[r * LP + kk];
            const float* vr = sV + kk * LD + sub;
#pragma unroll
            for (int j = 0; j < NC; ++j) acc[j] = fmaf(p, vr[kTpr * j], acc[j]);
        }
    }

    if (qi < Sq) {
        const float denom = fmaxf(l, 1e-30f);
        float* orow = o + ((long long)b * Sq + qi) * rs + (long long)h * D + sub;
#pragma unroll
        for (int j = 0; j < NC; ++j) orow[kTpr * j] = acc[j] / denom;
        if (sub == 0) lse[(long long)bh * Sq + qi] = l > 0.f ? m + logf(denom) : INFINITY;
    }
}

// ---------------------------------------------------------------------------
// K2 for f32: dK and dV. One block per (b*h, 64-row K tile); Q/dO tiles
// stream through.

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int8_t* __restrict__ mask,
                     float* __restrict__ dk, float* __restrict__ dv,
                     int H, int Sq, int Sk, long long msb, long long msq, long long msk,
                     Dropout dr) {
    constexpr int LD = D + 1, LP = kCols + 1, NC = D / kTpr, NS = kCols / kTpr;
    extern __shared__ float smem[];
    float* sK = smem;
    float* sV = sK + kRows * LD;
    float* sQ = sV + kRows * LD;
    float* sG = sQ + kCols * LD;
    float* sP = sG + kCols * LD;
    float* sS = sP + kRows * LP;
    float* sL = sS + kRows * LP;
    float* sD = sL + kCols;

    const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
    const int k0 = blockIdx.y * kRows;
    const int r = threadIdx.x / kTpr, sub = threadIdx.x % kTpr;
    const int kr = k0 + r;
    const long long rs = (long long)H * D;
    const float* qb = q + (long long)b * Sq * rs + (long long)h * D;
    const float* gb = g + (long long)b * Sq * rs + (long long)h * D;
    const float* kb = k + (long long)b * Sk * rs + (long long)h * D;
    const float* vb = v + (long long)b * Sk * rs + (long long)h * D;
    const int8_t* mcol = mask ? mask + b * msb + (long long)min(kr, Sk - 1) * msk : nullptr;

    load_tile<D>(sK, kb, rs, k0, Sk, kRows);
    load_tile<D>(sV, vb, rs, k0, Sk, kRows);

    float dka[NC], dva[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) dka[j] = dva[j] = 0.f;

    for (int q0 = 0; q0 < Sq; q0 += kCols) {
        __syncthreads();
        load_tile<D>(sQ, qb, rs, q0, Sq, kCols);
        load_tile<D>(sG, gb, rs, q0, Sq, kCols);
        for (int i = threadIdx.x; i < kCols; i += kThreads) {
            const bool in = q0 + i < Sq;
            sL[i] = in ? lse[(long long)bh * Sq + q0 + i] : INFINITY;
            sD[i] = in ? delta[(long long)bh * Sq + q0 + i] : 0.f;
        }
        __syncthreads();

#pragma unroll
        for (int j = 0; j < NS; ++j) {
            const int c = sub + kTpr * j, qi = q0 + c;
            float s = dot_rows<D>(sQ + c * LD, sK + r * LD);
            float gp = dot_rows<D>(sG + c * LD, sV + r * LD);
            if (mcol != nullptr && qi < Sq && mcol[qi * msq] == 0) s = kNegBig;
            const float p = expf(s - sL[c]);
            float pd = p;
            if constexpr (kDrop) {  // dV takes the dropped P, dS the dropped dO.V^T
                const bool kb = keep_bit(dr, bh, qi, kr);
                pd = dropped(kb, p, dr);
                gp = dropped(kb, gp, dr);
            }
            sP[r * LP + c] = pd;
            sS[r * LP + c] = p * (gp - sD[c]);
        }
        __syncwarp();
        for (int qq = 0; qq < kCols; ++qq) {
            const float p = sP[r * LP + qq], ds = sS[r * LP + qq];
            const float* gr = sG + qq * LD + sub;
            const float* qr = sQ + qq * LD + sub;
#pragma unroll
            for (int j = 0; j < NC; ++j) {
                dva[j] = fmaf(p, gr[kTpr * j], dva[j]);
                dka[j] = fmaf(ds, qr[kTpr * j], dka[j]);
            }
        }
    }

    if (kr < Sk) {
        const long long off = ((long long)b * Sk + kr) * rs + (long long)h * D + sub;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
            dk[off + kTpr * j] = dka[j];
            dv[off + kTpr * j] = dva[j];
        }
    }
}

// ---------------------------------------------------------------------------
// K3 for f32: dQ. One block per (b*h, 64-row Q tile); K/V tiles stream through.

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int8_t* __restrict__ mask,
                    float* __restrict__ dq,
                    int H, int Sq, int Sk, long long msb, long long msq, long long msk,
                    Dropout dr) {
    constexpr int LD = D + 1, LP = kCols + 1, NC = D / kTpr, NS = kCols / kTpr;
    extern __shared__ float smem[];
    float* sQ = smem;
    float* sG = sQ + kRows * LD;
    float* sK = sG + kRows * LD;
    float* sV = sK + kCols * LD;
    float* sS = sV + kCols * LD;

    const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
    const int q0 = blockIdx.y * kRows;
    const int r = threadIdx.x / kTpr, sub = threadIdx.x % kTpr;
    const int qi = q0 + r;
    const long long rs = (long long)H * D;
    const float* qb = q + (long long)b * Sq * rs + (long long)h * D;
    const float* gb = g + (long long)b * Sq * rs + (long long)h * D;
    const float* kb = k + (long long)b * Sk * rs + (long long)h * D;
    const float* vb = v + (long long)b * Sk * rs + (long long)h * D;
    const int8_t* mrow = mask ? mask + b * msb + (long long)min(qi, Sq - 1) * msq : nullptr;
    const float lse_r = qi < Sq ? lse[(long long)bh * Sq + qi] : INFINITY;
    const float delta_r = qi < Sq ? delta[(long long)bh * Sq + qi] : 0.f;

    load_tile<D>(sQ, qb, rs, q0, Sq, kRows);
    load_tile<D>(sG, gb, rs, q0, Sq, kRows);

    float dqa[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) dqa[j] = 0.f;

    for (int k0 = 0; k0 < Sk; k0 += kCols) {
        __syncthreads();
        load_tile<D>(sK, kb, rs, k0, Sk, kCols);
        load_tile<D>(sV, vb, rs, k0, Sk, kCols);
        __syncthreads();

#pragma unroll
        for (int j = 0; j < NS; ++j) {
            const int c = sub + kTpr * j, kc = k0 + c;
            float s = dot_rows<D>(sQ + r * LD, sK + c * LD);
            float gp = dot_rows<D>(sG + r * LD, sV + c * LD);
            const bool keep = kc < Sk && (mrow == nullptr || mrow[kc * msk] != 0);
            if (!keep) s = kNegBig;
            const float p = expf(s - lse_r);
            if constexpr (kDrop) gp = dropped(keep_bit(dr, bh, qi, kc), gp, dr);
            sS[r * LP + c] = p * (gp - delta_r);
        }
        __syncwarp();
        for (int kk = 0; kk < kCols; ++kk) {
            const float ds = sS[r * LP + kk];
            const float* kr = sK + kk * LD + sub;
#pragma unroll
            for (int j = 0; j < NC; ++j) dqa[j] = fmaf(ds, kr[kTpr * j], dqa[j]);
        }
    }

    if (qi < Sq) {
        float* row = dq + ((long long)b * Sq + qi) * ((long long)H * D) + (long long)h * D + sub;
#pragma unroll
        for (int j = 0; j < NC; ++j) row[kTpr * j] = dqa[j];
    }
}

// ---------------------------------------------------------------------------
// The bf16 kernels' shared pieces: 64-row tiles, four warps of 16 owned rows
// each (one warpgroup), keep-flag tiles. K1 (below) runs mma.sync fed by
// ldmatrix from cp.async tiles (the helpers up to store_strip); K2 and K3
// run wgmma on TMA tiles (after them).

constexpr int kTile = 64;                 // rows of an owned or streamed tile
constexpr int kMmaThreads = 128;          // four warps of 16 owned rows each
constexpr int kKeepLd = kTile + 4;        // bytes per row of a keep-flag tile

using bf16 = __nv_bfloat16;

// Shared tiles hold kTile rows of D bf16 with a 16-byte pad per row, which
// puts the eight rows one ldmatrix reads in eight distinct bank groups.
template <int D> __host__ __device__ constexpr int tile_ld() { return D + 8; }
template <int D> __host__ __device__ constexpr int tile_bytes() {
    return kTile * tile_ld<D>() * 2;
}

// Start copying rows [row0, row0 + kTile) of one (batch, head) slice into a
// shared tile, 16 bytes per cp.async; rows past n are zero-filled.
template <int D>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src, long long rs, int row0,
                                        int n) {
    constexpr int CPR = D / 8;  // 16-byte chunks per row
#pragma unroll
    for (int j = 0; j < kTile * CPR / kMmaThreads; ++j) {
        const int i = threadIdx.x + j * kMmaThreads, r = i / CPR, c = (i % CPR) * 8;
        const int gr = row0 + r;
        cp_async16(dst + r * tile_ld<D>() + c, src + (long long)min(gr, n - 1) * rs + c,
                   gr < n ? 16 : 0);
    }
}

// keep[r][c] is nonzero where query q0 + r may attend to key k0 + c: both
// in range and, given a mask (already offset to the batch), allowed by it.
// Returns whether any flag this thread wrote is set. Where the tile lies
// within Sk and the mask's rows are contiguous and 16-byte aligned (the
// Transformer's masks), a thread copies 16 mask bytes a load: two loads
// in flight instead of 32 one-byte loads.
__device__ __forceinline__ bool keep_tile(uint8_t* keep, const int8_t* mb, long long msq,
                                          long long msk, int q0, int Sq, int k0, int Sk) {
    bool any = false;
    if (mb != nullptr && msk == 1 && k0 + kTile <= Sk && msq % 16 == 0 &&
        reinterpret_cast<uintptr_t>(mb + k0) % 16 == 0) {
        constexpr int CPR = kTile / 16;  // 16-byte chunks per row
#pragma unroll
        for (int j = 0; j < kTile * CPR / kMmaThreads; ++j) {
            const int i = threadIdx.x + j * kMmaThreads, r = i / CPR, c = (i % CPR) * 16;
            const int qi = q0 + r;
            const uint4 f = qi < Sq ? *reinterpret_cast<const uint4*>(mb + qi * msq + k0 + c)
                                    : make_uint4(0, 0, 0, 0);
            uint32_t* dst = reinterpret_cast<uint32_t*>(keep + r * kKeepLd + c);
            dst[0] = f.x;
            dst[1] = f.y;
            dst[2] = f.z;
            dst[3] = f.w;
            any |= (f.x | f.y | f.z | f.w) != 0;
        }
        return any;
    }
#pragma unroll 8
    for (int j = 0; j < kTile * kTile / kMmaThreads; ++j) {
        const int i = threadIdx.x + j * kMmaThreads, r = i / kTile, c = i % kTile;
        const int qi = q0 + r, kc = k0 + c;
        bool ok = qi < Sq && kc < Sk;
        if (ok && mb != nullptr) ok = mb[qi * msq + kc * msk] != 0;
        keep[r * kKeepLd + c] = ok;
        any |= ok;
    }
    return any;
}

// A fragment: rows r0..r0+15, cols c0..c0+15 of a shared tile.
template <int D>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* tile, int r0, int c0,
                                       int lane) {
    ldsm_x4(a, tile + (r0 + (lane & 15)) * tile_ld<D>() + c0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles with B[k][n] = tile[n0 + n][k0 + k]: b[0], b[1]
// for n0..n0+7 and b[2], b[3] for n0+8..n0+15.
template <int D>
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], const bf16* tile, int n0, int k0,
                                        int lane) {
    ldsm_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * tile_ld<D>() + k0 +
                   ((lane >> 3) & 1) * 8);
}

// B fragments of two n8 tiles with B[k][n] = tile[k0 + k][n0 + n].
template <int D>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* tile, int k0, int n0,
                                       int lane) {
    ldsm_x4_t(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * tile_ld<D>() + n0 +
                     (lane >> 4) * 8);
}

// The A fragments of a warp's 16-row strip of a D-wide shared tile, held in
// registers where they fit (D <= 64) and read from shared memory otherwise.
template <int D>
struct Strip {
    static constexpr bool kHeld = D <= 64;
    uint32_t f[kHeld ? D / 16 : 1][4];
    const bf16* tile;
    int r0;

    __device__ __forceinline__ void init(const bf16* t, int r, int lane) {
        tile = t;
        r0 = r;
        if constexpr (kHeld) {
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) frag_a<D>(f[kk], t, r, kk * 16, lane);
        }
    }
    __device__ __forceinline__ void get(uint32_t (&a)[4], int kk, int lane) const {
        if constexpr (kHeld) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = f[kk][i];
        } else {
            frag_a<D>(a, tile, r0, kk * 16, lane);
        }
    }
};

// s += strip x rows n0..n0+15 of tile^T, over all of D (two n8 tiles).
template <int D>
__device__ __forceinline__ void strip_dot_rows(float (&s)[2][4], const Strip<D>& a,
                                               const bf16* tile, int n0, int lane) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t af[4], b[4];
        a.get(af, kk, lane);
        frag_bt<D>(b, tile, n0, kk * 16, lane);
        mma_bf16(s[0], af, b[0], b[1]);
        mma_bf16(s[1], af, b[2], b[3]);
    }
}

// acc (16 x D) += (a[0] + ... + a[N-1]) x rows k0..k0+15 of tile, each a[j]
// a 16 x 16 A fragment of the strip's rows (N = 2: a value split in two).
template <int D, int N>
__device__ __forceinline__ void strip_acc(float (&acc)[D / 8][4], const uint32_t (&a)[N][4],
                                          const bf16* tile, int k0, int lane) {
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        frag_b<D>(b, tile, k0, dn * 16, lane);
#pragma unroll
        for (int j = 0; j < N; ++j) {
            mma_bf16(acc[2 * dn], a[j], b[0], b[1]);
            mma_bf16(acc[2 * dn + 1], a[j], b[2], b[3]);
        }
    }
}

// Round a warp's 16 x D accumulator to bf16 into its own 16 rows of a shared
// tile (no other warp reads them), then store those rows with 16 bytes a
// lane; rows past n are not written.
template <int D>
__device__ __forceinline__ void store_strip(bf16* dst, bf16* tile, const float (&acc)[D / 8][4],
                                            int r0, int row0, int n, long long rs, int lane) {
    constexpr int LD = tile_ld<D>(), CPR = D / 8;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
        bf16* p = tile + (r0 + g) * LD + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(acc[j][0], acc[j][1]);
        *reinterpret_cast<uint32_t*>(p + 8 * LD) = pack_bf16(acc[j][2], acc[j][3]);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 16 * CPR / 32; ++j) {
        const int i = lane + 32 * j, r = r0 + i / CPR, c = (i % CPR) * 8;
        if (row0 + r < n)
            *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * rs + c) =
                *reinterpret_cast<const uint4*>(tile + r * LD + c);
    }
}

// K2 and K3 for bf16 inputs: one warpgroup on wgmma, tiles by TMA.
//
// Each block owns a 64-row tile (K2: keys, K3: queries) and walks the
// streamed axis (K2: Q tiles, K3: K tiles) through the list of tiles that
// its keep flags leave alive, built before the main loop:
//
// 1. Live tiles. The block scans its strip of the mask, 16 bytes a load,
//    several tiles' loads in flight at once, and keeps for each streamed
//    tile whether any of its 64 x 64 flags against the owned tile is set
//    and whether all are. A tile with none set is never copied, multiplied
//    or drawn for: its p is exp(-1e30 - lse) = 0 in every element, so it
//    adds exactly zero, and skipping it changes no bit. A tile with all set
//    takes no flag loads in the loop. The scan reads the mask as given
//    (padding, causal, cross, random or fully masked rows), never assuming
//    a shape. A block with no live tile writes zeros.
// 2. Dropout. An element's keep bit is word col % 4 of Philox4x32-10 on the
//    counter (col / 4, row, b*h, offset), so one call serves four
//    consecutive columns. K2's lanes 4a + y (y = 0..3) of one t hold keys
//    4a + y of a query: each draws one call in four and passes its words on
//    with two shuffles. K3's lanes t and t ^ 1 hold columns 2t, 2t + 1 of
//    rows g and g + 8: each draws one row's call and trades its half with
//    one shuffle. One call per four elements in both kernels; the bits are
//    the same as ops/attention.py::philox_keep's.
// 3. Products. Per streamed tile, S (K2: S^T = K Q^T) and dP (K2: dP^T =
//    V dO^T) are m64n64k16 wgmmas from shared memory; P and dS are formed in
//    the accumulators and go, rounded to bf16 (P as one term for dV, dS as
//    head + tail for dK and dQ), as register A operands into dV += P^T dO,
//    dK += dS^T Q (K2) or dQ += dS K (K3), B read MN-major from the same
//    tiles. The streamed tiles arrive by TMA into two stages, each
//    completing on its mbarrier, the next tile's copy (and its flags, lse
//    and delta) in flight while this one is computed. The first tile is
//    guessed (K3: tile 0; K2: tile 0 for a mask broadcast over queries,
//    the diagonal tile k0 / 64 otherwise) and copied together with the
//    owned tiles before the scan ends; a wrong guess costs one copy.

constexpr int kScanBatch = 8;  // streamed tiles whose mask loads the scan keeps in flight

template <int D> __host__ __device__ constexpr int tma_tile_bytes() { return kTile * D * 2; }
__host__ __device__ constexpr int align_1k(int x) { return (x + 1023) & ~1023; }

// Shared bytes of a stage: K2's Q and dO tiles, keep flags, lse and delta;
// K3's K and V tiles and keep flags.
template <int D> __host__ __device__ constexpr int dkv_stage_bytes() {
    return align_1k(2 * tma_tile_bytes<D>() + kTile * kKeepLd + 2 * kTile * (int)sizeof(float));
}
template <int D> __host__ __device__ constexpr int dq_stage_bytes() {
    return align_1k(2 * tma_tile_bytes<D>() + kTile * kKeepLd);
}

// Shared bytes after the stages: two mbarriers, the count, the scan's words
// (two per 32 streamed tiles) and the list (one int per streamed tile).
__host__ __device__ constexpr int live_bytes(int n_tiles) {
    return 32 + 8 * ((n_tiles + 31) / 32) + 4 * n_tiles;
}

// The whole dynamic shared memory of K2 or K3: 1 KB of slack to align the
// tiles to the 128B swizzle's 1024-byte period, the two owned tiles, one or
// two stages, then the barriers and the list.
template <int D>
int bwd_smem_bytes(int stage_bytes, int n_tiles) {
    return 1024 + 2 * tma_tile_bytes<D>() + (n_tiles > 1 ? 2 : 1) * stage_bytes +
           live_bytes(n_tiles);
}

struct LiveList {
    uint64_t* full;   // [2] one mbarrier per stage
    int* count;
    uint32_t* words;  // [2 * ceil(n_tiles / 32)]: some flag set, some flag clear
    int* list;        // [n_tiles]: j * 2 + (all flags set)

    __device__ LiveList(unsigned char* p, int n_tiles) {
        full = reinterpret_cast<uint64_t*>(p);
        count = reinterpret_cast<int*>(p + 16);
        words = reinterpret_cast<uint32_t*>(p + 32);
        list = reinterpret_cast<int*>(words + 2 * ((n_tiles + 31) / 32));
    }
};

// Copy one 64-row tile (rows row..row + 63 of head h of batch b) into
// shared memory, one TMA box per panel, completing on `bar`.
template <int D>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar, int h,
                                         int row, int b) {
    constexpr int P = panel_cols<D>();
#pragma unroll
    for (int p = 0; p < D / P; ++p) tma_load_4d(dst + p * kTile * P, map, bar, p * P, h, row, b);
}

__device__ __forceinline__ uint32_t bytes_clear(uint32_t w) {  // any byte zero
    return __vcmpeq4(w, 0u) != 0;
}

// The 16-byte mask chunks this thread reads of the 64 x 64 tile pair at
// (q0, k0): rows r and r + 32 (r = tid / 4), columns 16 (tid % 4)..; rows
// past Sq are zero. The layout of keep_tile's fast path.
__device__ __forceinline__ void mask_chunks(uint4 (&f)[2], const int8_t* mb, long long msq, int q0,
                                            int Sq, int k0) {
    const int r = threadIdx.x >> 2, c = (threadIdx.x & 3) * 16;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
        const int qi = q0 + r + 32 * u;
        f[u] = qi < Sq ? __ldg(reinterpret_cast<const uint4*>(mb + qi * msq + k0 + c))
                       : make_uint4(0, 0, 0, 0);
    }
}

// Of the flags a thread read: bit 0 if one is set, bit 1 if one is clear.
__device__ __forceinline__ uint32_t chunk_bits(const uint4 (&f)[2]) {
    uint32_t set = 0, clr = 0;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
        set |= (f[u].x | f[u].y | f[u].z | f[u].w) != 0;
        clr |= bytes_clear(f[u].x) | bytes_clear(f[u].y) | bytes_clear(f[u].z) |
               bytes_clear(f[u].w);
    }
    return set | clr << 1;
}

__device__ __forceinline__ void store_chunks(uint8_t* keep, const uint4 (&f)[2]) {
    const int r = threadIdx.x >> 2, c = (threadIdx.x & 3) * 16;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
        uint32_t* dst = reinterpret_cast<uint32_t*>(keep + (r + 32 * u) * kKeepLd + c);
        dst[0] = f[u].x;
        dst[1] = f[u].y;
        dst[2] = f[u].z;
        dst[3] = f[u].w;
    }
}

// The flags of one tile pair element by element (any strides, ragged
// edges, or no mask); writes them to keep unless it is null.
__device__ __forceinline__ uint32_t scan_slow(uint8_t* keep, const int8_t* mb, long long msq,
                                              long long msk, int q0, int Sq, int k0, int Sk) {
    uint32_t set = 0, clr = 0;
    for (int i = threadIdx.x; i < kTile * kTile; i += kMmaThreads) {
        const int r = i / kTile, c = i % kTile, qi = q0 + r, kc = k0 + c;
        bool ok = qi < Sq && kc < Sk;
        if (ok && mb != nullptr) ok = mb[qi * msq + kc * msk] != 0;
        if (keep != nullptr) keep[r * kKeepLd + c] = ok;
        set |= ok;
        clr |= !ok;
    }
    return set | clr << 1;
}

// Whether the tile pair with keys k0..k0 + 63 reads its flags 16 bytes a
// load: its keys lie within Sk and the mask's rows are contiguous and
// 16-byte aligned (the Transformer's and the LM's masks).
__device__ __forceinline__ bool flags_fast(const int8_t* mb, long long msq, long long msk, int k0,
                                           int Sk) {
    return mb != nullptr && msk == 1 && k0 + kTile <= Sk && msq % 16 == 0 &&
           reinterpret_cast<uintptr_t>(mb + k0) % 16 == 0;
}

// A streamed tile's flags (and K2's lse and delta) fetched into registers
// one tile ahead, stored to its stage after this tile's products.
struct Ahead {
    uint4 f[2];
    float lse, delta;
};

// Build the block's live list (see 1. above) and return its length. Tile j
// of the streamed axis meets the owned tile at origin(j) = (q0, k0); the
// flags of tile `guess` are also written to `keep`. Every thread calls it.
template <typename Origin>
__device__ int live_tiles(const LiveList& ll, int n_tiles, const int8_t* mb, long long msq,
                          long long msk, int Sq, int Sk, Origin origin, int guess,
                          uint8_t* keep) {
    const int tid = threadIdx.x, lane = tid & 31;
    auto fast = [&](int k0) { return flags_fast(mb, msq, msk, k0, Sk); };
    for (int c0 = 0; c0 < n_tiles; c0 += 32) {
        const int n = min(32, n_tiles - c0);
        uint32_t set = 0, clr = 0;
        for (int u0 = 0; u0 < n; u0 += kScanBatch) {
            uint4 f[kScanBatch][2];
#pragma unroll
            for (int u = 0; u < kScanBatch; ++u) {
                const int2 o = origin(c0 + u0 + u);
                if (u0 + u < n && fast(o.y)) mask_chunks(f[u], mb, msq, o.x, Sq, o.y);
            }
#pragma unroll
            for (int u = 0; u < kScanBatch; ++u) {
                const int j = c0 + u0 + u;
                if (u0 + u >= n) break;
                const int2 o = origin(j);
                uint32_t bits;
                if (fast(o.y)) {
                    bits = chunk_bits(f[u]);
                    if (j == guess) store_chunks(keep, f[u]);
                } else if (mb == nullptr && o.x + kTile <= Sq && o.y + kTile <= Sk) {
                    bits = 1;  // no mask, all in range: every flag set
                } else {
                    bits = scan_slow(j == guess ? keep : nullptr, mb, msq, msk, o.x, Sq, o.y, Sk);
                }
                set |= (bits & 1u) << (u0 + u);
                clr |= (bits >> 1) << (u0 + u);
            }
        }
        set = __reduce_or_sync(0xffffffffu, set);
        clr = __reduce_or_sync(0xffffffffu, clr);
        if (lane == 0) {
            atomicOr(&ll.words[2 * (c0 / 32)], set);
            atomicOr(&ll.words[2 * (c0 / 32) + 1], clr);
        }
    }
    __syncthreads();
    if (tid < 32) {
        int n = 0;
        for (int c0 = 0; c0 < n_tiles; c0 += 32) {
            const uint32_t set = ll.words[2 * (c0 / 32)], clr = ll.words[2 * (c0 / 32) + 1];
            const bool live = (set >> lane) & 1u;
            const uint32_t bal = __ballot_sync(0xffffffffu, live);
            if (live)
                ll.list[n + __popc(bal & ((1u << lane) - 1))] =
                    (c0 + lane) * 2 + !((clr >> lane) & 1u);
            n += __popc(bal);
        }
        if (lane == 0) *ll.count = n;
    }
    __syncthreads();
    return *ll.count;
}

__device__ __forceinline__ uint32_t keep_nibble(const uint4 w, const Dropout& dr) {
    return (uint32_t)(w.x < dr.thr) | (uint32_t)(w.y < dr.thr) << 1 |
           (uint32_t)(w.z < dr.thr) << 2 | (uint32_t)(w.w < dr.thr) << 3;
}

// K2's keep bits for the S^T accumulator of one tile pair: bit i is the bit
// of d[i] = (key k0 + 16 warp + g + 8 ((i >> 1) & 1), query q0 + 8 (i >> 2)
// + 2 t + (i & 1)). Key 4a + y of a query is word y of one call, and lanes
// 16a + 4y + t (y = 0..3) hold those four keys: in round r lane y draws
// element 4r + y's call, whose word y' is lane y''s bit; two rounds share
// two shuffles that gather the four nibbles, and each lane keeps its word.
__device__ __forceinline__ uint32_t dkv_keep_bits(const Dropout& dr, int bh, int q0, int k0,
                                                  int warp, int gi, int ti) {
    const int y = gi & 3;
    const uint32_t key4 = (uint32_t)(k0 >> 2) + 4 * warp + 2 * (y >> 1) + (gi >> 2);
    uint32_t out = 0;
#pragma unroll
    for (int r0 = 0; r0 < 8; r0 += 2) {
        uint32_t v = 0;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
            const int row = q0 + 8 * (r0 + rr) + 2 * ti + (y & 1);
            const uint4 w = philox4x32_10(
                make_uint4(key4, (uint32_t)row, (uint32_t)bh, dr.offset), dr.k0, dr.k1);
            v |= keep_nibble(w, dr) << (16 * rr + 4 * y);
        }
        v |= __shfl_xor_sync(0xffffffffu, v, 4);
        v |= __shfl_xor_sync(0xffffffffu, v, 8);
        // bits 16 rr + 4 x + y: element 4 (r0 + rr) + x of this lane
        uint32_t u = (v >> y) & 0x11111111u;
        u = (u | (u >> 3)) & 0x03030303u;
        u = (u | (u >> 6)) & 0x000F000Fu;
        u = (u | (u >> 12)) & 0xFFu;
        out |= u << (4 * r0);
    }
    return out;
}

// K3's keep bits for the S accumulator of one tile pair: bit i is the bit
// of d[i] = (query q0 + 16 warp + g + 8 ((i >> 1) & 1), key k0 + 8 (i >> 2)
// + 2 t + (i & 1)). Lanes t and t ^ 1 hold the four keys of one call in rows
// g and g + 8: lane t draws row g + 8 (t & 1), keeps its own two words and
// trades the other two with one shuffle.
__device__ __forceinline__ uint32_t dq_keep_bits(const Dropout& dr, int bh, int q0, int k0,
                                                 int warp, int gi, int ti) {
    const int odd = ti & 1;
    const uint32_t row = (uint32_t)(q0 + 16 * warp + gi + 8 * odd);
    uint32_t own = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const uint32_t key4 = (uint32_t)(k0 >> 2) + 2 * j + (ti >> 1);
        own |= keep_nibble(philox4x32_10(make_uint4(key4, row, (uint32_t)bh, dr.offset), dr.k0,
                                         dr.k1),
                           dr)
               << (4 * j);
    }
    const uint32_t other = __shfl_xor_sync(0xffffffffu, own, 1);
    return odd ? ((other >> 2) & 0x33333333u) | (own & 0xCCCCCCCCu)
               : (own & 0x33333333u) | ((other & 0x33333333u) << 2);
}

// Write a 64 x D accumulator (d[4j + i] = rows r0 + g (+ 8 for i >= 2),
// cols 8j + 2t (+ 1)) of rows row0.. as bf16: each warp rounds its own 16
// rows into `tile` (a staging area, D + 8 columns a row) and stores them 16
// bytes a lane; rows past n are not written.
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, bf16* tile, const float (&acc)[D / 2],
                                          int row0, int n, long long rs) {
    constexpr int LD = D + 8, CPR = D / 8;
    const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
    const int g = lane >> 2, t = lane & 3;
    __syncwarp();  // the warp's earlier reads of these rows are done
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
        bf16* p = tile + (r0 + g) * LD + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(p + 8 * LD) = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 16 * CPR / 32; ++j) {
        const int i = lane + 32 * j, r = r0 + i / CPR, c = (i % CPR) * 8;
        if (row0 + r < n)
            *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * rs + c) =
                *reinterpret_cast<const uint4*>(tile + r * LD + c);
    }
}

template <int D>
__device__ __forceinline__ void zero_rows(bf16* dst, int row0, int n, long long rs) {
    constexpr int CPR = D / 8;
    for (int i = threadIdx.x; i < kTile * CPR; i += kMmaThreads) {
        const int r = i / CPR, c = (i % CPR) * 8;
        if (row0 + r < n)
            *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * rs + c) =
                make_uint4(0, 0, 0, 0);
    }
}

// P and dS of one element: p = exp(s - lse) (s masked to -1e30 where the flag
// is clear; one ex2 a term); under dropout dV takes the dropped p and dS the
// dropped dP.
template <bool kDrop>
__device__ __forceinline__ void p_ds(float& p, float& ds, float s, float dp, float lse,
                                     float delta, bool kb, const Dropout& dr) {
    const float pv = exp2f((s - lse) * 1.4426950408889634f);
    if constexpr (kDrop) {
        ds = pv * (dropped(kb, dp, dr) - delta);
        p = dropped(kb, pv, dr);
    } else {
        ds = pv * (dp - delta);
        p = pv;
    }
}

// K2: one block per (b*h, 64-row K tile). Per live Q tile: S^T = K Q^T and
// dP^T = V dO^T (m64n64, from shared memory), then P^T, dS^T, and dV += P^T
// dO, dK += dS^T Q (m64nD, A from registers).
template <int D, bool kDrop>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_kernel_mma(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int8_t* __restrict__ mask, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int H, int Sq, int Sk, long long msb,
                         long long msq, long long msk, Dropout dr) {
    constexpr int TB = tma_tile_bytes<D>(), SB = dkv_stage_bytes<D>();
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
    bf16* sK = reinterpret_cast<bf16*>(smem);
    bf16* sV = reinterpret_cast<bf16*>(smem + TB);
    unsigned char* stages = smem + 2 * TB;
    const int n_tiles = (Sq + kTile - 1) / kTile;
    const LiveList ll(stages + (n_tiles > 1 ? 2 : 1) * SB, n_tiles);
    struct Stage {
        bf16 *q, *g;
        uint8_t* keep;
        float *lse, *delta;
    };
    auto stage = [&](int s) {
        unsigned char* p = stages + s * SB;
        Stage st;
        st.q = reinterpret_cast<bf16*>(p);
        st.g = reinterpret_cast<bf16*>(p + TB);
        st.keep = p + 2 * TB;
        st.lse = reinterpret_cast<float*>(st.keep + kTile * kKeepLd);
        st.delta = st.lse + kTile;
        return st;
    };

    const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
    const int k0 = blockIdx.y * kTile;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gi = lane >> 2, ti = lane & 3;
    const long long rs = (long long)H * D;
    const int8_t* mb = mask ? mask + b * msb : nullptr;
    const float* lse_b = lse + (long long)bh * Sq;
    const float* delta_b = delta + (long long)bh * Sq;

    if (tid == 0) {
        mbar_init(&ll.full[0], 1);
        mbar_init(&ll.full[1], 1);
        mbar_fence_init();
    }
    for (int i = tid; i < 2 * ((n_tiles + 31) / 32); i += kMmaThreads) ll.words[i] = 0;
    __syncthreads();

    // Stage s gets Q tile j's copy by TMA (and K, V with `own`) ...
    auto copy = [&](int s, int j, bool own) {
        if (tid == 0) {
            const Stage st = stage(s);
            mbar_expect_tx(&ll.full[s], (own ? 4 : 2) * TB);
            if (own) {
                tma_tile<D>(sK, &tm_k, &ll.full[s], h, k0, b);
                tma_tile<D>(sV, &tm_v, &ll.full[s], h, k0, b);
            }
            tma_tile<D>(st.q, &tm_q, &ll.full[s], h, j * kTile, b);
            tma_tile<D>(st.g, &tm_g, &ll.full[s], h, j * kTile, b);
        }
    };
    // ... and its flags (for a partial tile), lse and delta: fetched into
    // registers, then stored
    auto fetch = [&](int j, bool flags) {
        Ahead a;
        if (flags && flags_fast(mb, msq, msk, k0, Sk)) mask_chunks(a.f, mb, msq, j * kTile, Sq, k0);
        const int qi = j * kTile + tid;
        a.lse = tid < kTile && qi < Sq ? lse_b[qi] : INFINITY;
        a.delta = tid < kTile && qi < Sq ? delta_b[qi] : 0.f;
        return a;
    };
    auto put = [&](int s, int j, bool flags, const Ahead& a) {
        const Stage st = stage(s);
        if (flags) {
            if (flags_fast(mb, msq, msk, k0, Sk))
                store_chunks(st.keep, a.f);
            else
                scan_slow(st.keep, mb, msq, msk, j * kTile, Sq, k0, Sk);
        }
        if (tid < kTile) {
            st.lse[tid] = a.lse;
            st.delta[tid] = a.delta;
        }
    };
    // a mask broadcast over queries (padding) first meets tile 0, a causal
    // one the diagonal
    const int guess = mb != nullptr && msq != 0 ? min(k0 / kTile, n_tiles - 1) : 0;
    copy(0, guess, true);
    const Ahead first = fetch(guess, false);  // in flight during the scan
    const int n_live = live_tiles(
        ll, n_tiles, mb, msq, msk, Sq, Sk, [&](int j) { return make_int2(j * kTile, k0); }, guess,
        stage(0).keep);
    const long long off = (long long)b * Sk * rs + (long long)h * D;
    if (n_live == 0) {
        mbar_wait(&ll.full[0], 0);  // the guessed copies land before the block exits
        zero_rows<D>(dk + off, k0, Sk, rs);
        zero_rows<D>(dv + off, k0, Sk, rs);
        return;
    }
    put(0, guess, false, first);
    const int base = (ll.list[0] >> 1) == guess ? 0 : 1;  // entry i in stage (i + base) & 1
    uint32_t phase = 0;                                    // bit s: parity stage s waits for
    if (base) {  // the guess missed (so there are two stages): the first entry goes to stage 1
        const int j = ll.list[0] >> 1;
        const bool flags = !(ll.list[0] & 1);
        copy(1, j, false);
        put(1, j, flags, fetch(j, flags));
        mbar_wait(&ll.full[0], 0);  // K, V and the unused guess
        phase ^= 1u;
    }
    __syncthreads();  // the first entry's flags, lse and delta are in place

    float dka[D / 2] = {}, dva[D / 2] = {};
    for (int i = 0; i < n_live; ++i) {
        const int s = (i + base) & 1;
        const int j = ll.list[i] >> 1;
        const bool partial = !(ll.list[i] & 1);
        const bool more = i + 1 < n_live;
        const int jn1 = more ? ll.list[i + 1] >> 1 : 0;
        const bool flags1 = more && !(ll.list[i + 1] & 1);
        Ahead ahead;
        if (more) {
            copy(s ^ 1, jn1, false);
            ahead = fetch(jn1, flags1);
        }
        const Stage st = stage(s);
        mbar_wait(&ll.full[s], (phase >> s) & 1u);
        phase ^= 1u << s;

        float sa[32] = {}, dpa[32] = {};
        fence_regs(sa);
        fence_regs(dpa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss_n64(sa, desc_k<D>(sK, kk), desc_k<D>(st.q, kk));
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss_n64(dpa, desc_k<D>(sV, kk), desc_k<D>(st.g, kk));
        wgmma_commit();
        uint32_t kbits = 0;  // drawn while the tensor cores work
        if constexpr (kDrop) kbits = dkv_keep_bits(dr, bh, j * kTile, k0, warp, gi, ti);
        wgmma_wait<0>();
        fence_regs(sa);
        fence_regs(dpa);

        // d[i] = (key 16 warp + g + 8 ((i >> 1) & 1), query 8 (i >> 2) + 2 t + (i & 1))
        if (partial) {
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                const int qr = 8 * (i >> 2) + 2 * ti + (i & 1);
                const int kr = 16 * warp + gi + 8 * ((i >> 1) & 1);
                if (!st.keep[qr * kKeepLd + kr]) sa[i] = kNegBig;
            }
        }
        uint32_t pa[4][4], ha[4][4], ta[4][4];
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
            const float2 l2 = *reinterpret_cast<const float2*>(st.lse + 8 * jn + 2 * ti);
            const float2 d2 = *reinterpret_cast<const float2*>(st.delta + 8 * jn + 2 * ti);
            float p[4], ds[4];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                const int i4 = 4 * jn + x;
                p_ds<kDrop>(p[x], ds[x], sa[i4], dpa[i4], (x & 1) ? l2.y : l2.x,
                            (x & 1) ? d2.y : d2.x, (kbits >> i4) & 1u, dr);
            }
            const int kk = jn >> 1, half = jn & 1;
            pa[kk][2 * half] = pack_bf16(p[0], p[1]);
            pa[kk][2 * half + 1] = pack_bf16(p[2], p[3]);
            pack_bf16_split(ds[0], ds[1], ha[kk][2 * half], ta[kk][2 * half]);
            pack_bf16_split(ds[2], ds[3], ha[kk][2 * half + 1], ta[kk][2 * half + 1]);
        }
        fence_regs(dka);
        fence_regs(dva);
        fence_regs(pa);
        fence_regs(ha);
        fence_regs(ta);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(dva, pa[kk], desc_mn<D>(st.g, kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            wgmma_rs<D>(dka, ha[kk], desc_mn<D>(st.q, kk));
            wgmma_rs<D>(dka, ta[kk], desc_mn<D>(st.q, kk));
        }
        wgmma_commit();
        if (more) put(s ^ 1, jn1, flags1, ahead);  // while the tensor cores work
        wgmma_wait<0>();
        fence_regs(dka);
        fence_regs(dva);
        fence_regs(pa);
        fence_regs(ha);
        fence_regs(ta);
        __syncthreads();  // stage s is refilled next iteration; stage s ^ 1 is in place
    }

    fence_proxy_async();  // the staging below overwrites bytes TMA wrote
    bf16* staging = stage(0).q;
    store_acc<D>(dk + off, staging, dka, k0, Sk, rs);
    store_acc<D>(dv + off, staging, dva, k0, Sk, rs);
}

// K3: one block per (b*h, 64-row Q tile). Per live K tile: S = Q K^T and
// dP = dO V^T (m64n64, from shared memory), then P, dS, and dQ += dS K
// (m64nD, dS as two bf16 A operands from registers).
template <int D, bool kDrop>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_kernel_mma(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_g,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int8_t* __restrict__ mask, bf16* __restrict__ dq, int H, int Sq,
                        int Sk, long long msb, long long msq, long long msk, Dropout dr) {
    constexpr int TB = tma_tile_bytes<D>(), SB = dq_stage_bytes<D>();
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
    bf16* sQ = reinterpret_cast<bf16*>(smem);
    bf16* sG = reinterpret_cast<bf16*>(smem + TB);
    unsigned char* stages = smem + 2 * TB;
    const int n_tiles = (Sk + kTile - 1) / kTile;
    const LiveList ll(stages + (n_tiles > 1 ? 2 : 1) * SB, n_tiles);
    struct Stage {
        bf16 *k, *v;
        uint8_t* keep;
    };
    auto stage = [&](int s) {
        unsigned char* p = stages + s * SB;
        Stage st;
        st.k = reinterpret_cast<bf16*>(p);
        st.v = reinterpret_cast<bf16*>(p + TB);
        st.keep = p + 2 * TB;
        return st;
    };

    const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
    const int q0 = blockIdx.y * kTile;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gi = lane >> 2, ti = lane & 3;
    const long long rs = (long long)H * D;
    const int8_t* mb = mask ? mask + b * msb : nullptr;

    if (tid == 0) {
        mbar_init(&ll.full[0], 1);
        mbar_init(&ll.full[1], 1);
        mbar_fence_init();
    }
    for (int i = tid; i < 2 * ((n_tiles + 31) / 32); i += kMmaThreads) ll.words[i] = 0;
    __syncthreads();

    auto copy = [&](int s, int j, bool own) {
        if (tid == 0) {
            const Stage st = stage(s);
            mbar_expect_tx(&ll.full[s], (own ? 4 : 2) * TB);
            if (own) {
                tma_tile<D>(sQ, &tm_q, &ll.full[s], h, q0, b);
                tma_tile<D>(sG, &tm_g, &ll.full[s], h, q0, b);
            }
            tma_tile<D>(st.k, &tm_k, &ll.full[s], h, j * kTile, b);
            tma_tile<D>(st.v, &tm_v, &ll.full[s], h, j * kTile, b);
        }
    };
    auto fetch = [&](int j, bool flags) {
        Ahead a;
        if (flags && flags_fast(mb, msq, msk, j * kTile, Sk))
            mask_chunks(a.f, mb, msq, q0, Sq, j * kTile);
        return a;
    };
    auto put = [&](int s, int j, bool flags, const Ahead& a) {
        if (!flags) return;
        const Stage st = stage(s);
        if (flags_fast(mb, msq, msk, j * kTile, Sk))
            store_chunks(st.keep, a.f);
        else
            scan_slow(st.keep, mb, msq, msk, q0, Sq, j * kTile, Sk);
    };
    copy(0, 0, true);  // the guess: K tile 0
    float lse_r[2], delta_r[2];  // of the thread's rows 16 warp + g and + 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int qi = q0 + 16 * warp + gi + 8 * i;
        lse_r[i] = qi < Sq ? lse[(long long)bh * Sq + qi] : INFINITY;
        delta_r[i] = qi < Sq ? delta[(long long)bh * Sq + qi] : 0.f;
    }
    const int n_live = live_tiles(
        ll, n_tiles, mb, msq, msk, Sq, Sk, [&](int j) { return make_int2(q0, j * kTile); }, 0,
        stage(0).keep);
    const long long off = (long long)b * Sq * rs + (long long)h * D;
    if (n_live == 0) {
        mbar_wait(&ll.full[0], 0);
        zero_rows<D>(dq + off, q0, Sq, rs);
        return;
    }
    const int base = (ll.list[0] >> 1) == 0 ? 0 : 1;
    uint32_t phase = 0;
    if (base) {
        const int j = ll.list[0] >> 1;
        const bool flags = !(ll.list[0] & 1);
        copy(1, j, false);
        put(1, j, flags, fetch(j, flags));
        mbar_wait(&ll.full[0], 0);
        phase ^= 1u;
        __syncthreads();
    }

    float dqa[D / 2] = {};
    for (int i = 0; i < n_live; ++i) {
        const int s = (i + base) & 1;
        const int j = ll.list[i] >> 1;
        const bool partial = !(ll.list[i] & 1);
        const bool more = i + 1 < n_live;
        const int jn1 = more ? ll.list[i + 1] >> 1 : 0;
        const bool flags1 = more && !(ll.list[i + 1] & 1);
        Ahead ahead;
        if (more) {
            copy(s ^ 1, jn1, false);
            ahead = fetch(jn1, flags1);
        }
        const Stage st = stage(s);
        mbar_wait(&ll.full[s], (phase >> s) & 1u);
        phase ^= 1u << s;

        float sa[32] = {}, dpa[32] = {};
        fence_regs(sa);
        fence_regs(dpa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss_n64(sa, desc_k<D>(sQ, kk), desc_k<D>(st.k, kk));
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss_n64(dpa, desc_k<D>(sG, kk), desc_k<D>(st.v, kk));
        wgmma_commit();
        uint32_t kbits = 0;
        if constexpr (kDrop) kbits = dq_keep_bits(dr, bh, q0, j * kTile, warp, gi, ti);
        wgmma_wait<0>();
        fence_regs(sa);
        fence_regs(dpa);

        // d[i] = (query 16 warp + g + 8 ((i >> 1) & 1), key 8 (i >> 2) + 2 t + (i & 1))
        if (partial) {
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                const int qr = 16 * warp + gi + 8 * ((i >> 1) & 1);
                const int kr = 8 * (i >> 2) + 2 * ti + (i & 1);
                if (!st.keep[qr * kKeepLd + kr]) sa[i] = kNegBig;
            }
        }
        uint32_t ha[4][4], ta[4][4];
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
            float ds[4];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                const int i4 = 4 * jn + x;
                float p;
                p_ds<kDrop>(p, ds[x], sa[i4], dpa[i4], lse_r[x >> 1], delta_r[x >> 1],
                            (kbits >> i4) & 1u, dr);
            }
            const int kk = jn >> 1, half = jn & 1;
            pack_bf16_split(ds[0], ds[1], ha[kk][2 * half], ta[kk][2 * half]);
            pack_bf16_split(ds[2], ds[3], ha[kk][2 * half + 1], ta[kk][2 * half + 1]);
        }
        fence_regs(dqa);
        fence_regs(ha);
        fence_regs(ta);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            wgmma_rs<D>(dqa, ha[kk], desc_mn<D>(st.k, kk));
            wgmma_rs<D>(dqa, ta[kk], desc_mn<D>(st.k, kk));
        }
        wgmma_commit();
        if (more) put(s ^ 1, jn1, flags1, ahead);
        wgmma_wait<0>();
        fence_regs(dqa);
        fence_regs(ha);
        fence_regs(ta);
        __syncthreads();
    }

    fence_proxy_async();
    store_acc<D>(dq + off, stage(0).k, dqa, q0, Sq, rs);
}

// K1 on the tensor cores. One block per (b*h, 64-row Q tile); K/V tiles and
// their keep flags stream through two shared stages by cp.async. Per warp and
// per K tile: S = Q_w K^T (16 x 64) in registers, the online softmax on its
// accumulator fragments (each row's four lanes share its max by shuffles),
// and acc = alpha acc + P V with P as two bf16 A fragments (head + tail) in
// registers.
// A K tile whose 64 x 64 keep flags are all zero is skipped by the whole
// block: it would add exp(-1e30 - m) = 0 to every sum, so skipping it is
// exact (a row that saw only such tiles keeps m = -inf instead of -5e29,
// and every later alpha is 0 either way).
template <int D> __host__ __device__ constexpr int fwd_stage_bytes() {
    return 2 * tile_bytes<D>() + kTile * kKeepLd;
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int8_t* __restrict__ mask,
                     bf16* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Sk,
                     long long msb, long long msq, long long msk, Dropout dr) {
    extern __shared__ __align__(16) unsigned char smem_mma[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_mma);
    unsigned char* stages = smem_mma + tile_bytes<D>();
    struct Stage {
        bf16 *k, *v;
        uint8_t* keep;
    };
    auto stage = [&](int s) {
        unsigned char* p = stages + s * fwd_stage_bytes<D>();
        Stage st;
        st.k = reinterpret_cast<bf16*>(p);
        st.v = reinterpret_cast<bf16*>(p + tile_bytes<D>());
        st.keep = p + 2 * tile_bytes<D>();
        return st;
    };

    const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
    const int q0 = blockIdx.y * kTile;
    const int lane = threadIdx.x & 31, qw = (threadIdx.x >> 5) * 16;
    const int gi = lane >> 2, ti = lane & 3;
    const long long rs = (long long)H * D;
    const bf16* kb = k + (long long)b * Sk * rs + (long long)h * D;
    const bf16* vb = v + (long long)b * Sk * rs + (long long)h * D;
    const int8_t* mb = mask ? mask + b * msb : nullptr;

    auto load_k_tile = [&](int it) {
        const Stage st = stage(it & 1);
        const int k0 = it * kTile;
        cp_tile<D>(st.k, kb, rs, k0, Sk);
        cp_tile<D>(st.v, vb, rs, k0, Sk);
        cp_async_commit();
        return keep_tile(st.keep, mb, msq, msk, q0, Sq, k0, Sk);
    };

    const long long off = (long long)b * Sq * rs + (long long)h * D;
    cp_tile<D>(sQ, q + off, rs, q0, Sq);
    bool any = load_k_tile(0);  // one group: Q and the first K/V tile

    // Per thread: rows qw + gi and qw + gi + 8 (index r), running max m[r]
    // and the thread's partial row sum l[r] of its own columns.
    float acc[D / 8][4] = {}, m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    Strip<D> fq;
    const int n_tiles = (Sk + kTile - 1) / kTile;
    for (int it = 0; it < n_tiles; ++it) {
        bool any_next = false;
        if (it + 1 < n_tiles) {
            any_next = load_k_tile(it + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        const bool live = __syncthreads_or(any);
        any = any_next;
        if (it == 0) fq.init(sQ, qw, lane);
        if (!live) {
            __syncthreads();  // the stage is refilled next iteration
            continue;
        }
        const Stage st = stage(it & 1);
        float s[kTile / 16][2][4] = {};
#pragma unroll
        for (int kc = 0; kc < kTile / 16; ++kc) strip_dot_rows<D>(s[kc], fq, st.k, kc * 16, lane);

        // s[kc][n][i] is (row qw + gi + 8 (i >> 1), key kc 16 + 8 n + 2 ti + (i & 1))
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int kc = 0; kc < kTile / 16; ++kc)
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int qr = qw + gi + 8 * (i >> 1), kr = kc * 16 + 8 * n + 2 * ti + (i & 1);
                    if (!st.keep[qr * kKeepLd + kr]) s[kc][n][i] = kNegBig;
                    mx[i >> 1] = fmaxf(mx[i >> 1], s[kc][n][i]);
                }
        float alpha[2], m_new[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            m_new[r] = fmaxf(fmaxf(m[r], group_max(mx[r])), 0.5f * kNegBig);
            alpha[r] = expf(m[r] - m_new[r]);  // 0 on the first live tile (m = -inf)
            m[r] = m_new[r];
            l[r] *= alpha[r];
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j][i] *= alpha[i >> 1];
#pragma unroll
        for (int kc = 0; kc < kTile / 16; ++kc) {
            uint32_t pa[2][4];
#pragma unroll
            for (int n = 0; n < 2; ++n) {
                float p[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    p[i] = expf(s[kc][n][i] - m_new[i >> 1]);
                    l[i >> 1] += p[i];  // l sums the probabilities before dropout
                }
                if constexpr (kDrop) {
                    // rows q0 + qw + gi (+ 8), keys it * kTile + 16 kc + 8 n + 2 ti (+ 1)
                    const int row = q0 + qw + gi, col = it * kTile + kc * 16 + 8 * n + 2 * ti;
                    bool kb[4];
                    keep_pair(dr, bh, row, col, kb[0], kb[1]);
                    keep_pair(dr, bh, row + 8, col, kb[2], kb[3]);
#pragma unroll
                    for (int i = 0; i < 4; ++i) p[i] = dropped(kb[i], p[i], dr);
                }
                pack_bf16_split(p[0], p[1], pa[0][2 * n], pa[1][2 * n]);
                pack_bf16_split(p[2], p[3], pa[0][2 * n + 1], pa[1][2 * n + 1]);
            }
            strip_acc<D>(acc, pa, st.v, kc * 16, lane);
        }
        __syncthreads();  // the stage is refilled next iteration
    }

    float denom[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] = group_sum(l[r]);
        denom[r] = fmaxf(l[r], 1e-30f);
        const int qi = q0 + qw + gi + 8 * r;
        if (ti == 0 && qi < Sq)
            lse[(long long)bh * Sq + qi] = l[r] > 0.f ? m[r] + logf(denom[r]) : INFINITY;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] /= denom[i >> 1];
    // the warp's own rows of the Q tile: no other warp reads them
    store_strip<D>(o + off, sQ, acc, qw, q0, Sq, rs, lane);
}

template <int D> constexpr int fwd_smem() {
    return (int)sizeof(float) * (kRows * (D + 1) + 2 * kCols * (D + 1) + kRows * (kCols + 1));
}
template <int D> constexpr int dkv_smem() {
    return (int)sizeof(float) *
           (2 * kRows * (D + 1) + 2 * kCols * (D + 1) + 2 * kRows * (kCols + 1) + 2 * kCols);
}
template <int D> constexpr int dq_smem() {
    return (int)sizeof(float) * (2 * kRows * (D + 1) + 2 * kCols * (D + 1) + kRows * (kCols + 1));
}

// Shared memory above 48 KB needs an opt-in per kernel instantiation: both
// of a kernel's (with and without dropout) are opted in together.
template <typename Kernel>
cudaError_t allow_smem(Kernel plain, Kernel drop, int bytes) {
    const cudaError_t e =
        cudaFuncSetAttribute(plain, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(drop, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ---------------------------------------------------------------------------
// TMA tensor maps of the (B, S, H, D) bf16 tensors, as they lie in memory:
// dims (D, H, S, B) innermost first, row stride H*D, no copy. A box is one
// panel of a 64-row tile of one (batch, head); rows past S read as zero.
// cuTensorMapEncodeTiled is a driver function, reached through the runtime's
// entry-point query, so the library links no -lcuda. Encoding is host work
// on every launch (four maps a launch; flash_tensor_map_ns times it).

// Returned by an entry point when no tensor map could be made: the driver
// lacks the encoder, or it refused the tensor (kMapError + its CUresult).
constexpr int kMapError = 1000;
constexpr int kMaxSmem = 232448;  // 227 KB: a block's most shared memory on sm_90

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

EncodeTiled tensor_map_encoder() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
        const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                               cudaEnableDefault, &q);
        return e == cudaSuccess && q == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p)
                   : nullptr;
    }();
    return fn;
}

template <int D>
int tile_map(CUtensorMap* map, const void* base, int B, int S, int H) {
    const EncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return kMapError;
    constexpr int P = panel_cols<D>();
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                   (cuuint64_t)S * H * D * 2};
    const cuuint32_t box[4] = {(cuuint32_t)P, 1, (cuuint32_t)kTile, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : kMapError + (int)r;
}

// The four maps of one K2 or K3 launch.
template <int D>
int bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v, const void* g,
             int B, int H, int Sq, int Sk) {
    int e = tile_map<D>(&m[0], q, B, Sq, H);
    if (e == 0) e = tile_map<D>(&m[1], k, B, Sk, H);
    if (e == 0) e = tile_map<D>(&m[2], v, B, Sk, H);
    if (e == 0) e = tile_map<D>(&m[3], g, B, Sq, H);
    return e;
}

// bf16 goes to the tensor-core kernels, f32 to the CUDA-core ones. K1 takes
// one stage of streamed tiles when there is only one tile to stream, two
// otherwise (the opt-in covers two); K2 and K3 size their shared memory by
// the streamed tiles' count (bwd_smem_bytes; the opt-in covers 227 KB). A
// rate above 0 selects the instantiation that draws the dropout.
template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
               void* lse, int B, int H, int Sq, int Sk, long long msb, long long msq,
               long long msk, float rate, unsigned long long seed, unsigned long long offset,
               cudaStream_t stream) {
    const Dropout dr = make_dropout(rate, seed, offset);
    if constexpr (std::is_same_v<T, bf16>) {
        constexpr int fixed = tile_bytes<D>(), per_stage = fwd_stage_bytes<D>();
        static const cudaError_t attr = allow_smem(
            flash_fwd_kernel_mma<D, false>, flash_fwd_kernel_mma<D, true>, fixed + 2 * per_stage);
        if (attr != cudaSuccess) return (int)attr;
        const int smem = fixed + (Sk > kTile ? 2 : 1) * per_stage;
        dim3 grid(B * H, (Sq + kTile - 1) / kTile);
        auto kernel = rate > 0.f ? flash_fwd_kernel_mma<D, true> : flash_fwd_kernel_mma<D, false>;
        kernel<<<grid, kMmaThreads, smem, stream>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int8_t*)mask, (bf16*)o,
            (float*)lse, H, Sq, Sk, msb, msq, msk, dr);
        return (int)cudaGetLastError();
    } else {
        constexpr int smem = fwd_smem<D>();
        static const cudaError_t attr =
            allow_smem(flash_fwd_kernel<D, false>, flash_fwd_kernel<D, true>, smem);
        if (attr != cudaSuccess) return (int)attr;
        dim3 grid(B * H, (Sq + kRows - 1) / kRows);
        auto kernel = rate > 0.f ? flash_fwd_kernel<D, true> : flash_fwd_kernel<D, false>;
        kernel<<<grid, kThreads, smem, stream>>>(
            (const T*)q, (const T*)k, (const T*)v, (const int8_t*)mask, (T*)o, (float*)lse,
            H, Sq, Sk, msb, msq, msk, dr);
        return (int)cudaGetLastError();
    }
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* g, const void* lse,
               const void* delta, const void* mask, void* dk, void* dv, int B, int H, int Sq,
               int Sk, long long msb, long long msq, long long msk, float rate,
               unsigned long long seed, unsigned long long offset, cudaStream_t stream) {
    const Dropout dr = make_dropout(rate, seed, offset);
    if constexpr (std::is_same_v<T, bf16>) {
        static const cudaError_t attr = allow_smem(
            flash_bwd_dkv_kernel_mma<D, false>, flash_bwd_dkv_kernel_mma<D, true>, kMaxSmem);
        if (attr != cudaSuccess) return (int)attr;
        const int smem = bwd_smem_bytes<D>(dkv_stage_bytes<D>(), (Sq + kTile - 1) / kTile);
        if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
        CUtensorMap m[4];
        const int e = bwd_maps<D>(m, q, k, v, g, B, H, Sq, Sk);
        if (e != 0) return e;
        dim3 grid(B * H, (Sk + kTile - 1) / kTile);
        auto kernel = rate > 0.f ? flash_bwd_dkv_kernel_mma<D, true>
                                 : flash_bwd_dkv_kernel_mma<D, false>;
        kernel<<<grid, kMmaThreads, smem, stream>>>(
            m[0], m[1], m[2], m[3], (const float*)lse, (const float*)delta, (const int8_t*)mask,
            (bf16*)dk, (bf16*)dv, H, Sq, Sk, msb, msq, msk, dr);
        return (int)cudaGetLastError();
    } else {
        constexpr int smem = dkv_smem<D>();
        static const cudaError_t attr =
            allow_smem(flash_bwd_dkv_kernel<D, false>, flash_bwd_dkv_kernel<D, true>, smem);
        if (attr != cudaSuccess) return (int)attr;
        dim3 grid(B * H, (Sk + kRows - 1) / kRows);
        auto kernel = rate > 0.f ? flash_bwd_dkv_kernel<D, true> : flash_bwd_dkv_kernel<D, false>;
        kernel<<<grid, kThreads, smem, stream>>>(
            (const T*)q, (const T*)k, (const T*)v, (const T*)g, (const float*)lse,
            (const float*)delta, (const int8_t*)mask, (T*)dk, (T*)dv, H, Sq, Sk, msb, msq, msk,
            dr);
        return (int)cudaGetLastError();
    }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* g, const void* lse,
              const void* delta, const void* mask, void* dq, int B, int H, int Sq, int Sk,
              long long msb, long long msq, long long msk, float rate, unsigned long long seed,
              unsigned long long offset, cudaStream_t stream) {
    const Dropout dr = make_dropout(rate, seed, offset);
    if constexpr (std::is_same_v<T, bf16>) {
        static const cudaError_t attr = allow_smem(
            flash_bwd_dq_kernel_mma<D, false>, flash_bwd_dq_kernel_mma<D, true>, kMaxSmem);
        if (attr != cudaSuccess) return (int)attr;
        const int smem = bwd_smem_bytes<D>(dq_stage_bytes<D>(), (Sk + kTile - 1) / kTile);
        if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
        CUtensorMap m[4];
        const int e = bwd_maps<D>(m, q, k, v, g, B, H, Sq, Sk);
        if (e != 0) return e;
        dim3 grid(B * H, (Sq + kTile - 1) / kTile);
        auto kernel = rate > 0.f ? flash_bwd_dq_kernel_mma<D, true>
                                 : flash_bwd_dq_kernel_mma<D, false>;
        kernel<<<grid, kMmaThreads, smem, stream>>>(
            m[0], m[1], m[2], m[3], (const float*)lse, (const float*)delta, (const int8_t*)mask,
            (bf16*)dq, H, Sq, Sk, msb, msq, msk, dr);
        return (int)cudaGetLastError();
    } else {
        constexpr int smem = dq_smem<D>();
        static const cudaError_t attr =
            allow_smem(flash_bwd_dq_kernel<D, false>, flash_bwd_dq_kernel<D, true>, smem);
        if (attr != cudaSuccess) return (int)attr;
        dim3 grid(B * H, (Sq + kRows - 1) / kRows);
        auto kernel = rate > 0.f ? flash_bwd_dq_kernel<D, true> : flash_bwd_dq_kernel<D, false>;
        kernel<<<grid, kThreads, smem, stream>>>(
            (const T*)q, (const T*)k, (const T*)v, (const T*)g, (const float*)lse,
            (const float*)delta, (const int8_t*)mask, (T*)dq, H, Sq, Sk, msb, msq, msk, dr);
        return (int)cudaGetLastError();
    }
}

}  // namespace

// Dispatch on (dtype, head dim). dtype: 0 = float32, 1 = bfloat16. An
// unsupported pair returns cudaErrorInvalidValue; the Python wrapper checks
// both before it calls. rate is the attention dropout rate in [0, 1) (0:
// none), seed and offset the Philox key and counter word it draws from.
#define FLASH_DISPATCH(LAUNCH, ...)                                                    \
    switch (D * 2 + is_bf16) {                                                         \
        case 64: return LAUNCH<float, 32>(__VA_ARGS__);                                \
        case 65: return LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__);                        \
        case 128: return LAUNCH<float, 64>(__VA_ARGS__);                               \
        case 129: return LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);                       \
        case 256: return LAUNCH<float, 128>(__VA_ARGS__);                              \
        case 257: return LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);                      \
        default: return (int)cudaErrorInvalidValue;                                    \
    }

extern "C" {

int flash_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
              void* lse, int B, int H, int Sq, int Sk, int D, int is_bf16, long long msb,
              long long msq, long long msk, float rate, unsigned long long seed,
              unsigned long long offset, void* stream) {
    FLASH_DISPATCH(launch_fwd, q, k, v, mask, o, lse, B, H, Sq, Sk, msb, msq, msk, rate, seed,
                   offset, (cudaStream_t)stream)
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                  const void* lse, const void* delta, const void* mask, void* dk, void* dv,
                  int B, int H, int Sq, int Sk, int D, int is_bf16, long long msb,
                  long long msq, long long msk, float rate, unsigned long long seed,
                  unsigned long long offset, void* stream) {
    FLASH_DISPATCH(launch_dkv, q, k, v, g, lse, delta, mask, dk, dv, B, H, Sq, Sk, msb, msq,
                   msk, rate, seed, offset, (cudaStream_t)stream)
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* g, const void* lse,
                 const void* delta, const void* mask, void* dq, int B, int H, int Sq, int Sk,
                 int D, int is_bf16, long long msb, long long msq, long long msk, float rate,
                 unsigned long long seed, unsigned long long offset, void* stream) {
    FLASH_DISPATCH(launch_dq, q, k, v, g, lse, delta, mask, dq, B, H, Sq, Sk, msb, msq, msk,
                   rate, seed, offset, (cudaStream_t)stream)
}

// Mean nanoseconds of encoding one K2 or K3 launch's four tensor maps over
// n repetitions, for a (B, S, H, D) bf16 tensor at `base` (a device
// allocation: the driver checks it) standing for q, k, v and dO: the host
// cost the TMA design adds to every launch. Negative if a map is refused.
int flash_tensor_map_ns(const void* base, int B, int S, int H, int D, int n) {
    CUtensorMap m[4];
    tensor_map_encoder();  // the one-time entry-point query is not timed
    const auto t0 = std::chrono::steady_clock::now();
    for (int i = 0; i < n; ++i) {
        const int e = D == 32    ? bwd_maps<32>(m, base, base, base, base, B, H, S, S)
                      : D == 64  ? bwd_maps<64>(m, base, base, base, base, B, H, S, S)
                      : D == 128 ? bwd_maps<128>(m, base, base, base, base, B, H, S, S)
                                 : (int)cudaErrorInvalidValue;
        if (e != 0) return -e;
    }
    const auto t1 = std::chrono::steady_clock::now();
    return (int)(std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0).count() /
                 (n > 0 ? n : 1));
}

}  // extern "C"
