// Flash attention for the demo Transformer, written for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of metaopt_tpu/ops/attention.py:
//   flash_fwd_kernel     <- _flash_fwd_kernel      (launched by _pallas_forward)
//   flash_bwd_dkv_kernel <- _flash_bwd_dkv_kernel  (pass 1 of _pallas_backward)
//   flash_bwd_dq_kernel  <- _flash_bwd_dq_kernel   (pass 2 of _pallas_backward)
//
// What bounds them on an H100: at the demo Transformer's shapes (B 32,
// S 64, H 8, D 64, bf16) each call moves 8-12 MB and does 0.3-0.5 GFLOP,
// so all three are memory-bound (a few microseconds at 3.35 TB/s).
// The design answers that bound by never writing the (Sq, Sk) score
// matrix to device memory: each block streams tiles of the other axis
// through shared memory and keeps the running softmax statistics and the
// output accumulator on chip, so device memory sees each input read about
// once per tile row and each output written once. This first version
// computes in f32 on the CUDA cores (no wgmma, TMA or warp specialisation)
// and reads tensors straight from the (B, S, H, D) layout through strides,
// so no transposed or padded copies are made.
//
// Semantics kept from the Pallas bodies:
//   - q arrives pre-scaled; compute is f32 from f32 or bf16 inputs;
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
//     dQ by one block per Q tile, no atomics.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // 64 rows x 4 threads per row
constexpr int kRows = 64;               // rows of the tile a block owns
constexpr int kCols = 64;               // rows of the tile streamed per step
constexpr int kTpr = 4;                 // threads per owned row
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// Copy rows [row0, row0 + rows) of one (batch, head) slice into shared
// memory as f32 with a padded leading dimension; rows past n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride,
                                          int row0, int n, int rows) {
    constexpr int LD = D + 1;
    for (int i = threadIdx.x; i < rows * D; i += kThreads) {
        const int r = i / D, c = i - r * D;
        const int g = row0 + r;
        dst[r * LD + c] = g < n ? to_f32(src[(long long)g * row_stride + c]) : 0.f;
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int8_t* __restrict__ mask, T* __restrict__ o, float* __restrict__ lse,
                 int H, int Sq, int Sk, long long msb, long long msq, long long msk) {
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
    const T* qb = q + (long long)b * Sq * rs + (long long)h * D;
    const T* kb = k + (long long)b * Sk * rs + (long long)h * D;
    const T* vb = v + (long long)b * Sk * rs + (long long)h * D;
    const int8_t* mrow = mask ? mask + b * msb + (long long)min(qi, Sq - 1) * msq : nullptr;

    load_tile<T, D>(sQ, qb, rs, q0, Sq, kRows);

    float m = -INFINITY, l = 0.f, acc[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] = 0.f;

    for (int k0 = 0; k0 < Sk; k0 += kCols) {
        __syncthreads();  // everyone is done with the previous K/V tile
        load_tile<T, D>(sK, kb, rs, k0, Sk, kCols);
        load_tile<T, D>(sV, vb, rs, k0, Sk, kCols);
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
        T* orow = o + ((long long)b * Sq + qi) * rs + (long long)h * D + sub;
#pragma unroll
        for (int j = 0; j < NC; ++j) orow[kTpr * j] = from_f32<T>(acc[j] / denom);
        if (sub == 0) lse[(long long)bh * Sq + qi] = l > 0.f ? m + logf(denom) : INFINITY;
    }
}

// ---------------------------------------------------------------------------
// K2: dK and dV. One block per (b*h, 64-row K tile); Q/dO tiles stream through.

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ g, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int8_t* __restrict__ mask,
                     T* __restrict__ dk, T* __restrict__ dv,
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
    const T* qb = q + (long long)b * Sq * rs + (long long)h * D;
    const T* gb = g + (long long)b * Sq * rs + (long long)h * D;
    const T* kb = k + (long long)b * Sk * rs + (long long)h * D;
    const T* vb = v + (long long)b * Sk * rs + (long long)h * D;
    const int8_t* mcol = mask ? mask + b * msb + (long long)min(kr, Sk - 1) * msk : nullptr;

    load_tile<T, D>(sK, kb, rs, k0, Sk, kRows);
    load_tile<T, D>(sV, vb, rs, k0, Sk, kRows);

    float dka[NC], dva[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) dka[j] = dva[j] = 0.f;

    for (int q0 = 0; q0 < Sq; q0 += kCols) {
        __syncthreads();
        load_tile<T, D>(sQ, qb, rs, q0, Sq, kCols);
        load_tile<T, D>(sG, gb, rs, q0, Sq, kCols);
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
            dk[off + kTpr * j] = from_f32<T>(dka[j]);
            dv[off + kTpr * j] = from_f32<T>(dva[j]);
        }
    }
}

// ---------------------------------------------------------------------------
// K3: dQ. One block per (b*h, 64-row Q tile); K/V tiles stream through.

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int8_t* __restrict__ mask,
                    T* __restrict__ dq,
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
    const T* qb = q + (long long)b * Sq * rs + (long long)h * D;
    const T* gb = g + (long long)b * Sq * rs + (long long)h * D;
    const T* kb = k + (long long)b * Sk * rs + (long long)h * D;
    const T* vb = v + (long long)b * Sk * rs + (long long)h * D;
    const int8_t* mrow = mask ? mask + b * msb + (long long)min(qi, Sq - 1) * msq : nullptr;
    const float lse_r = qi < Sq ? lse[(long long)bh * Sq + qi] : INFINITY;
    const float delta_r = qi < Sq ? delta[(long long)bh * Sq + qi] : 0.f;

    load_tile<T, D>(sQ, qb, rs, q0, Sq, kRows);
    load_tile<T, D>(sG, gb, rs, q0, Sq, kRows);

    float dqa[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) dqa[j] = 0.f;

    for (int k0 = 0; k0 < Sk; k0 += kCols) {
        __syncthreads();
        load_tile<T, D>(sK, kb, rs, k0, Sk, kCols);
        load_tile<T, D>(sV, vb, rs, k0, Sk, kCols);
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
        T* row = dq + ((long long)b * Sq + qi) * ((long long)H * D) + (long long)h * D + sub;
#pragma unroll
        for (int j = 0; j < NC; ++j) row[kTpr * j] = from_f32<T>(dqa[j]);
    }
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

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
               void* lse, int B, int H, int Sq, int Sk, long long msb, long long msq,
               long long msk, cudaStream_t stream) {
    constexpr int smem = fwd_smem<D>();
    static const cudaError_t attr = allow_smem(flash_fwd_kernel<T, D>, smem);
    if (attr != cudaSuccess) return (int)attr;
    dim3 grid(B * H, (Sq + kRows - 1) / kRows);
    flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int8_t*)mask, (T*)o, (float*)lse,
        H, Sq, Sk, msb, msq, msk);
    return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* g, const void* lse,
               const void* delta, const void* mask, void* dk, void* dv, int B, int H, int Sq,
               int Sk, long long msb, long long msq, long long msk, cudaStream_t stream) {
    constexpr int smem = dkv_smem<D>();
    static const cudaError_t attr = allow_smem(flash_bwd_dkv_kernel<T, D>, smem);
    if (attr != cudaSuccess) return (int)attr;
    dim3 grid(B * H, (Sk + kRows - 1) / kRows);
    flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)g, (const float*)lse,
        (const float*)delta, (const int8_t*)mask, (T*)dk, (T*)dv, H, Sq, Sk, msb, msq, msk);
    return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* g, const void* lse,
              const void* delta, const void* mask, void* dq, int B, int H, int Sq, int Sk,
              long long msb, long long msq, long long msk, cudaStream_t stream) {
    constexpr int smem = dq_smem<D>();
    static const cudaError_t attr = allow_smem(flash_bwd_dq_kernel<T, D>, smem);
    if (attr != cudaSuccess) return (int)attr;
    dim3 grid(B * H, (Sq + kRows - 1) / kRows);
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)g, (const float*)lse,
        (const float*)delta, (const int8_t*)mask, (T*)dq, H, Sq, Sk, msb, msq, msk);
    return (int)cudaGetLastError();
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
