// Flash attention for the demo Transformer, written for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of metaopt_tpu/ops/attention.py:
//   flash_fwd_kernel_mma      <- _flash_fwd_kernel     (launched by _pallas_forward), bf16
//   flash_bwd_dkv_kernel_mma  <- _flash_bwd_dkv_kernel (pass 1 of _pallas_backward), bf16
//   flash_bwd_dq_kernel_mma   <- _flash_bwd_dq_kernel  (pass 2 of _pallas_backward), bf16
//   flash_fwd_kernel, flash_bwd_dkv_kernel, flash_bwd_dq_kernel: the same for f32
//
// What bounds them on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense). At the
// demo Transformer's shape (B 32, S 64, H 8, D 64, bf16, padding mask) each
// call moves 8-13 MB and does 0.3-0.5 GFLOP, so all three are bound by
// bytes: K1 2.5 us, K2 3.8 us, K3 3.2 us. At the Transformer's longest
// sequence (B 8, S 512, H 8, D 64, causal mask) the work per byte grows
// with S: K2 is bound by operations (8.6 GFLOP, 8.7 us), K3 and K1 still
// by bytes (7.0 and 5.7 us). chip_smoke.py computes these bounds.
//
// Common design: the (Sq, Sk) score matrix never reaches device memory.
// Each block owns a 64-row tile of one (batch, head), streams 64-row tiles
// of the other axis through shared memory and keeps its accumulators on
// chip; tensors are read straight from the (B, S, H, D) layout through
// strides, so no transposed or padded copies are made.
//
// In bf16 all three run on the tensor cores, FlashAttention-2 style: four
// warps of 16 owned rows, tiles copied to shared memory as bf16 with
// cp.async, two stages so the next tile's copy overlaps this tile's math,
// and every product as mma.sync m16n8k16 fed by ldmatrix. Score, P and dP
// tiles stay in registers, and their accumulator layout is the A-fragment
// layout of the next product, so P and dS never touch shared memory. Bound
// by bytes, K1 reads Q, K and V once each, as bf16, with 16-byte copies
// that overlap the math of the tile before, reads the mask 16 bytes a load
// (keep_tile), and writes O through 16-byte stores; its online softmax
// runs on the score fragments, the row max and sum shared by the row's
// four lanes with two shuffles. K tiles whose keep flags are all zero for
// the block's Q tile (a causal mask's upper triangle, padded keys) are
// skipped whole: 28 of the 64 tile pairs of a causal 512 x 512 mask. At
// S = 64 a block does one tile step and needs
// 32 KB (K1, D = 64) to 41 KB (K2) of shared memory, and registers (see
// ptxas -v) let two or more blocks share an SM, so the slice's 256 blocks
// are resident in one wave on 132 SMs and one block's loads overlap
// another's math. wgmma and TMA are left for long sequences, where the
// tensor cores, not latency, should set the time.
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
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "warp_mma.cuh"

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
// K1: forward. One block per (b*h, 64-row Q tile); K/V tiles stream through.

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int8_t* __restrict__ mask,
                 float* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Sk,
                 long long msb, long long msq, long long msk) {
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
            const float p = expf(s[j] - m_new);
            psum += p;
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int8_t* __restrict__ mask,
                     float* __restrict__ dk, float* __restrict__ dv,
                     int H, int Sq, int Sk, long long msb, long long msq, long long msk) {
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
            const float gp = dot_rows<D>(sG + c * LD, sV + r * LD);
            if (mcol != nullptr && qi < Sq && mcol[qi * msq] == 0) s = kNegBig;
            const float p = expf(s - sL[c]);
            sP[r * LP + c] = p;
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int8_t* __restrict__ mask,
                    float* __restrict__ dq,
                    int H, int Sq, int Sk, long long msb, long long msq, long long msk) {
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
            const float gp = dot_rows<D>(sG + r * LD, sV + c * LD);
            const bool keep = kc < Sk && (mrow == nullptr || mrow[kc * msk] != 0);
            if (!keep) s = kNegBig;
            const float p = expf(s - lse_r);
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
// K2 and K3 for bf16 inputs, on the tensor cores. Four warps per block; each
// warp owns 16 rows of the block's 64-row tile and computes, per 16-row
// chunk of the streamed tile, both score products with mma.sync into
// registers, the probabilities and dS there, and feeds them, rounded to
// bf16 (dS as head + tail), straight into the next products as A fragments.

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

// K2 on the tensor cores. One block per (b*h, 64-row K tile); Q/dO tiles,
// their keep flags, lse and delta stream through two shared stages, the
// copy of tile i + 1 in flight while tile i is computed. Per warp and per
// 16 query rows: S^T = K_w Q^T and dP^T = V_w dO^T (16 x 16 each), then
// P^T = exp(S^T - lse), dS^T = P^T (dP^T - delta), and dV_w += P^T dO,
// dK_w += dS^T Q with P^T and dS^T (two terms) as bf16 A fragments.
template <int D> __host__ __device__ constexpr int dkv_stage_bytes() {
    return 2 * tile_bytes<D>() + kTile * kKeepLd + 2 * kTile * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int8_t* __restrict__ mask, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int H, int Sq, int Sk, long long msb,
                         long long msq, long long msk) {
    extern __shared__ __align__(16) unsigned char smem_mma[];
    bf16* sK = reinterpret_cast<bf16*>(smem_mma);
    bf16* sV = reinterpret_cast<bf16*>(smem_mma + tile_bytes<D>());
    unsigned char* stages = smem_mma + 2 * tile_bytes<D>();
    struct Stage {
        bf16 *q, *g;
        uint8_t* keep;
        float *lse, *delta;
    };
    auto stage = [&](int s) {
        unsigned char* p = stages + s * dkv_stage_bytes<D>();
        Stage st;
        st.q = reinterpret_cast<bf16*>(p);
        st.g = reinterpret_cast<bf16*>(p + tile_bytes<D>());
        st.keep = p + 2 * tile_bytes<D>();
        st.lse = reinterpret_cast<float*>(st.keep + kTile * kKeepLd);
        st.delta = st.lse + kTile;
        return st;
    };

    const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
    const int k0 = blockIdx.y * kTile;
    const int lane = threadIdx.x & 31, kw = (threadIdx.x >> 5) * 16;
    const int gi = lane >> 2, ti = lane & 3;
    const long long rs = (long long)H * D;
    const bf16* qb = q + (long long)b * Sq * rs + (long long)h * D;
    const bf16* gb = g + (long long)b * Sq * rs + (long long)h * D;
    const int8_t* mb = mask ? mask + b * msb : nullptr;
    const float* lse_b = lse + (long long)bh * Sq;
    const float* delta_b = delta + (long long)bh * Sq;

    auto load_q_tile = [&](int it) {
        const Stage st = stage(it & 1);
        const int q0 = it * kTile;
        cp_tile<D>(st.q, qb, rs, q0, Sq);
        cp_tile<D>(st.g, gb, rs, q0, Sq);
        cp_async_commit();
        keep_tile(st.keep, mb, msq, msk, q0, Sq, k0, Sk);
        if (threadIdx.x < kTile) {
            const int qi = q0 + threadIdx.x;
            st.lse[threadIdx.x] = qi < Sq ? lse_b[qi] : INFINITY;
            st.delta[threadIdx.x] = qi < Sq ? delta_b[qi] : 0.f;
        }
    };

    cp_tile<D>(sK, k + (long long)b * Sk * rs + (long long)h * D, rs, k0, Sk);
    cp_tile<D>(sV, v + (long long)b * Sk * rs + (long long)h * D, rs, k0, Sk);
    load_q_tile(0);  // one group: K, V and the first Q/dO tile

    float dka[D / 8][4] = {}, dva[D / 8][4] = {};
    Strip<D> fk, fv;
    const int n_tiles = (Sq + kTile - 1) / kTile;
    for (int it = 0; it < n_tiles; ++it) {
        if (it + 1 < n_tiles) {
            load_q_tile(it + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if (it == 0) {
            fk.init(sK, kw, lane);
            fv.init(sV, kw, lane);
        }
        const Stage st = stage(it & 1);
#pragma unroll
        for (int qc = 0; qc < kTile; qc += 16) {
            float s[2][4] = {}, dp[2][4] = {};
            strip_dot_rows<D>(s, fk, st.q, qc, lane);
            strip_dot_rows<D>(dp, fv, st.g, qc, lane);
            uint32_t pa[1][4], da[2][4];
#pragma unroll
            for (int n = 0; n < 2; ++n) {
                float p[4], ds[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int qr = qc + 8 * n + 2 * ti + (i & 1), kr = kw + gi + 8 * (i >> 1);
                    const float sv = st.keep[qr * kKeepLd + kr] ? s[n][i] : kNegBig;
                    p[i] = expf(sv - st.lse[qr]);
                    ds[i] = p[i] * (dp[n][i] - st.delta[qr]);
                }
                pa[0][2 * n] = pack_bf16(p[0], p[1]);
                pa[0][2 * n + 1] = pack_bf16(p[2], p[3]);
                pack_bf16_split(ds[0], ds[1], da[0][2 * n], da[1][2 * n]);
                pack_bf16_split(ds[2], ds[3], da[0][2 * n + 1], da[1][2 * n + 1]);
            }
            strip_acc<D>(dva, pa, st.g, qc, lane);
            strip_acc<D>(dka, da, st.q, qc, lane);
        }
        __syncthreads();  // the stage is refilled next iteration
    }

    const long long off = (long long)b * Sk * rs + (long long)h * D;
    store_strip<D>(dk + off, sK, dka, kw, k0, Sk, rs, lane);
    store_strip<D>(dv + off, sV, dva, kw, k0, Sk, rs, lane);
}

// K3 on the tensor cores. One block per (b*h, 64-row Q tile); K/V tiles and
// their keep flags stream through two shared stages. Per warp and per 16
// keys: S = Q_w K^T and dP = dO_w V^T, P = exp(S - lse), dS = P (dP - delta),
// and dQ_w += dS K with dS as two bf16 A fragments.
template <int D> __host__ __device__ constexpr int dq_stage_bytes() {
    return 2 * tile_bytes<D>() + kTile * kKeepLd;
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ g,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int8_t* __restrict__ mask, bf16* __restrict__ dq, int H, int Sq,
                        int Sk, long long msb, long long msq, long long msk) {
    extern __shared__ __align__(16) unsigned char smem_mma[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_mma);
    bf16* sG = reinterpret_cast<bf16*>(smem_mma + tile_bytes<D>());
    unsigned char* stages = smem_mma + 2 * tile_bytes<D>();
    struct Stage {
        bf16 *k, *v;
        uint8_t* keep;
    };
    auto stage = [&](int s) {
        unsigned char* p = stages + s * dq_stage_bytes<D>();
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
    float lse_r[2], delta_r[2];  // of the thread's rows qw + gi and qw + gi + 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int qi = q0 + qw + gi + 8 * i;
        lse_r[i] = qi < Sq ? lse[(long long)bh * Sq + qi] : INFINITY;
        delta_r[i] = qi < Sq ? delta[(long long)bh * Sq + qi] : 0.f;
    }

    auto load_k_tile = [&](int it) {
        const Stage st = stage(it & 1);
        const int k0 = it * kTile;
        cp_tile<D>(st.k, kb, rs, k0, Sk);
        cp_tile<D>(st.v, vb, rs, k0, Sk);
        cp_async_commit();
        keep_tile(st.keep, mb, msq, msk, q0, Sq, k0, Sk);
    };

    const long long off = (long long)b * Sq * rs + (long long)h * D;
    cp_tile<D>(sQ, q + off, rs, q0, Sq);
    cp_tile<D>(sG, g + off, rs, q0, Sq);
    load_k_tile(0);  // one group: Q, dO and the first K/V tile

    float dqa[D / 8][4] = {};
    Strip<D> fq, fg;
    const int n_tiles = (Sk + kTile - 1) / kTile;
    for (int it = 0; it < n_tiles; ++it) {
        if (it + 1 < n_tiles) {
            load_k_tile(it + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if (it == 0) {
            fq.init(sQ, qw, lane);
            fg.init(sG, qw, lane);
        }
        const Stage st = stage(it & 1);
#pragma unroll
        for (int kc = 0; kc < kTile; kc += 16) {
            float s[2][4] = {}, dp[2][4] = {};
            strip_dot_rows<D>(s, fq, st.k, kc, lane);
            strip_dot_rows<D>(dp, fg, st.v, kc, lane);
            uint32_t da[2][4];
#pragma unroll
            for (int n = 0; n < 2; ++n) {
                float ds[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int qr = qw + gi + 8 * (i >> 1), kr = kc + 8 * n + 2 * ti + (i & 1);
                    const float sv = st.keep[qr * kKeepLd + kr] ? s[n][i] : kNegBig;
                    const float p = expf(sv - lse_r[i >> 1]);
                    ds[i] = p * (dp[n][i] - delta_r[i >> 1]);
                }
                pack_bf16_split(ds[0], ds[1], da[0][2 * n], da[1][2 * n]);
                pack_bf16_split(ds[2], ds[3], da[0][2 * n + 1], da[1][2 * n + 1]);
            }
            strip_acc<D>(dqa, da, st.k, kc, lane);
        }
        __syncthreads();  // the stage is refilled next iteration
    }

    store_strip<D>(dq + off, sQ, dqa, qw, q0, Sq, rs, lane);
}

// K1 on the tensor cores. One block per (b*h, 64-row Q tile); K/V tiles and
// their keep flags stream through two shared stages, as in K3. Per warp and
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

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int8_t* __restrict__ mask,
                     bf16* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Sk,
                     long long msb, long long msq, long long msk) {
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
                    l[i >> 1] += p[i];
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

// Shared memory above 48 KB needs an opt-in per kernel instantiation.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// bf16 goes to the tensor-core kernels, f32 to the CUDA-core ones. The
// tensor-core kernels take one stage of streamed tiles when there is only
// one tile to stream, two otherwise (the opt-in covers two).
template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
               void* lse, int B, int H, int Sq, int Sk, long long msb, long long msq,
               long long msk, cudaStream_t stream) {
    if constexpr (std::is_same_v<T, bf16>) {
        constexpr int fixed = tile_bytes<D>(), per_stage = fwd_stage_bytes<D>();
        static const cudaError_t attr =
            allow_smem(flash_fwd_kernel_mma<D>, fixed + 2 * per_stage);
        if (attr != cudaSuccess) return (int)attr;
        const int smem = fixed + (Sk > kTile ? 2 : 1) * per_stage;
        dim3 grid(B * H, (Sq + kTile - 1) / kTile);
        flash_fwd_kernel_mma<D><<<grid, kMmaThreads, smem, stream>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int8_t*)mask, (bf16*)o,
            (float*)lse, H, Sq, Sk, msb, msq, msk);
        return (int)cudaGetLastError();
    } else {
        constexpr int smem = fwd_smem<D>();
        static const cudaError_t attr = allow_smem(flash_fwd_kernel<D>, smem);
        if (attr != cudaSuccess) return (int)attr;
        dim3 grid(B * H, (Sq + kRows - 1) / kRows);
        flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
            (const T*)q, (const T*)k, (const T*)v, (const int8_t*)mask, (T*)o, (float*)lse,
            H, Sq, Sk, msb, msq, msk);
        return (int)cudaGetLastError();
    }
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* g, const void* lse,
               const void* delta, const void* mask, void* dk, void* dv, int B, int H, int Sq,
               int Sk, long long msb, long long msq, long long msk, cudaStream_t stream) {
    if constexpr (std::is_same_v<T, bf16>) {
        constexpr int fixed = 2 * tile_bytes<D>(), per_stage = dkv_stage_bytes<D>();
        static const cudaError_t attr =
            allow_smem(flash_bwd_dkv_kernel_mma<D>, fixed + 2 * per_stage);
        if (attr != cudaSuccess) return (int)attr;
        const int smem = fixed + (Sq > kTile ? 2 : 1) * per_stage;
        dim3 grid(B * H, (Sk + kTile - 1) / kTile);
        flash_bwd_dkv_kernel_mma<D><<<grid, kMmaThreads, smem, stream>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g, (const float*)lse,
            (const float*)delta, (const int8_t*)mask, (bf16*)dk, (bf16*)dv, H, Sq, Sk, msb,
            msq, msk);
        return (int)cudaGetLastError();
    } else {
        constexpr int smem = dkv_smem<D>();
        static const cudaError_t attr = allow_smem(flash_bwd_dkv_kernel<D>, smem);
        if (attr != cudaSuccess) return (int)attr;
        dim3 grid(B * H, (Sk + kRows - 1) / kRows);
        flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
            (const T*)q, (const T*)k, (const T*)v, (const T*)g, (const float*)lse,
            (const float*)delta, (const int8_t*)mask, (T*)dk, (T*)dv, H, Sq, Sk, msb, msq, msk);
        return (int)cudaGetLastError();
    }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* g, const void* lse,
              const void* delta, const void* mask, void* dq, int B, int H, int Sq, int Sk,
              long long msb, long long msq, long long msk, cudaStream_t stream) {
    if constexpr (std::is_same_v<T, bf16>) {
        constexpr int fixed = 2 * tile_bytes<D>(), per_stage = dq_stage_bytes<D>();
        static const cudaError_t attr =
            allow_smem(flash_bwd_dq_kernel_mma<D>, fixed + 2 * per_stage);
        if (attr != cudaSuccess) return (int)attr;
        const int smem = fixed + (Sk > kTile ? 2 : 1) * per_stage;
        dim3 grid(B * H, (Sq + kTile - 1) / kTile);
        flash_bwd_dq_kernel_mma<D><<<grid, kMmaThreads, smem, stream>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g, (const float*)lse,
            (const float*)delta, (const int8_t*)mask, (bf16*)dq, H, Sq, Sk, msb, msq, msk);
        return (int)cudaGetLastError();
    } else {
        constexpr int smem = dq_smem<D>();
        static const cudaError_t attr = allow_smem(flash_bwd_dq_kernel<D>, smem);
        if (attr != cudaSuccess) return (int)attr;
        dim3 grid(B * H, (Sq + kRows - 1) / kRows);
        flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
            (const T*)q, (const T*)k, (const T*)v, (const T*)g, (const float*)lse,
            (const float*)delta, (const int8_t*)mask, (T*)dq, H, Sq, Sk, msb, msq, msk);
        return (int)cudaGetLastError();
    }
}

}  // namespace

// Dispatch on (dtype, head dim). dtype: 0 = float32, 1 = bfloat16. An
// unsupported pair returns cudaErrorInvalidValue; the Python wrapper checks
// both before it calls.
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
              long long msq, long long msk, void* stream) {
    FLASH_DISPATCH(launch_fwd, q, k, v, mask, o, lse, B, H, Sq, Sk, msb, msq, msk,
                   (cudaStream_t)stream)
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                  const void* lse, const void* delta, const void* mask, void* dk, void* dv,
                  int B, int H, int Sq, int Sk, int D, int is_bf16, long long msb,
                  long long msq, long long msk, void* stream) {
    FLASH_DISPATCH(launch_dkv, q, k, v, g, lse, delta, mask, dk, dv, B, H, Sq, Sk, msb, msq,
                   msk, (cudaStream_t)stream)
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* g, const void* lse,
                 const void* delta, const void* mask, void* dq, int B, int H, int Sq, int Sk,
                 int D, int is_bf16, long long msb, long long msq, long long msk,
                 void* stream) {
    FLASH_DISPATCH(launch_dq, q, k, v, g, lse, delta, mask, dq, B, H, Sq, Sk, msb, msq, msk,
                   (cudaStream_t)stream)
}

}  // extern "C"
