// TPE's EI scorer, written for Hopper (sm_90a): one launch scores every
// candidate of every member and picks each output slot's winner.
//
// Replaces the XLA program that scores and picks TPE's candidates in
// metaopt_tpu/ops/tpe_math.py (the reference wrote it in XLA, not Pallas):
// _truncnorm_mixture_logpdf_1d (:67), vmapped over the columns (:86-89),
// inside ei_scores (:94) and the winner pick of _tpe_suggest_body
// (:342-350). In the port it takes the place of the plain PyTorch chain
// of metaopt_tpu_torch/ops/tpe_math.py (_mixture_logpdf, ei_scores,
// _score_rows, then torch.argmax), which stays beside the wrapper as
// ei_argmax_plain: the CPU's path and the card's oracle.
//
// What it computes, for member b, candidate c and column j:
//   continuous j:  log l = logsumexp_i(-z*z/2 - log(2 pi)/2 - log sig_i
//                                      - log mass_i + log w_i),
//                  z = (x - mu_i) / sig_i, over the good set's components,
//                  mass_i = clamp(ndtr((1 - mu_i) / sig_i)
//                                 - ndtr(-mu_i / sig_i), 1e-12, 1);
//                  log g the same over the bad set's;
//   categorical j: log l, log g looked up in the (d, kmax) tables at
//                  min(trunc(x * k), k - 1), k = max(n_choices_j, 1), or
//                  at the index the caller gives;
//   score = sum over j, in column order, of (log l - log g);
// then for each of the n_out slots the argmax over its n_cand consecutive
// candidates with torch.argmax's rules: the first maximum wins, a NaN
// counts as the maximum. Padding components (log w = -inf) add nothing;
// a mixture with no finite term gives -inf, as torch.logsumexp does. Each
// term is computed in the plain version's order with rounded intrinsics
// (no contraction into FMAs), ndtr as torch computes it in float,
// (1 + erf(x / sqrt 2)) / 2, so the kernel differs from the plain
// version by the exp/log/erf implementations and the log-sum-exp's order
// alone.
//
// What bounds it on an H100 (67 TFLOP/s f32 outside the tensor cores,
// 3.35 TB/s). Per candidate, component and continuous column: one
// exponential and about ten f32 operations. At n ~10k (good and bad pads
// 4096 and 8192), 192 candidates and 3 continuous columns that is ~7.1M
// terms, ~1.2 us at the f32 peak; the inputs (components, candidates,
// tables) are under 0.6 MB, 0.2 us. So the work is bound by operations,
// and at the main path's sizes by latency: a solo launch has n_out
// blocks. The plain chain it replaces runs 80-odd kernels per pool and
// writes (..., C, N, d) intermediates to device memory (12.6 MB each at
// C 192, N 4096, d 4); this kernel keeps every term in registers and
// writes only the scores and the winners. chip_smoke.py computes the
// bound of each launch it times.
//
// Design (simple first):
//   - one block per (member, output slot); its warps take one candidate
//     each (at most 32 at a time; a slot of more candidates runs rounds);
//   - for each continuous column and each of the two mixtures, the block
//     stages the member's components through shared memory, one tile of
//     blockDim components at a time; while loading, each thread computes
//     its component's log sig and log mass, so the truncation mass costs
//     one erf pair per component per block and round, and no pre-pass
//     launch is needed;
//   - the lanes of a warp stride over the tile's components and keep an
//     online log-sum-exp (max, scaled sum) in registers; the lanes merge
//     through a fixed xor-shuffle tree, and lane 0 sums the columns in
//     order;
//   - once every warp has written its scores, thread 0 takes the slot's
//     argmax in candidate order.
// No atomics, and no block reads another member's data: a member's row is
// the same bits whatever B, so a fused bucket row equals the member's solo
// row on the card. d, the pads, kmax, n_cand and n_out are runtime
// arguments. The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxWarps = 32;
constexpr int kMaxThreads = 32 * kMaxWarps;

// One mixture component of one column, as the block stages it.
struct Comp {
    float mu, sig, log_sig, log_mass, log_w;
};

// torch's float ndtr on the CPU: (1 + erf(x * sqrt(1/2))) * 0.5.
__device__ __forceinline__ float ndtr(float x) {
    return __fmul_rn(__fadd_rn(1.0f, erff(__fmul_rn(x, 0.70710678118654752f))), 0.5f);
}

// Online log-sum-exp: m the largest term so far, s the sum of exp(term - m).
// A -inf term adds nothing; a NaN term makes s NaN, and so the result.
__device__ __forceinline__ void lse_push(float& m, float& s, float v) {
    if (v > m) {
        s = __fadd_rn(__fmul_rn(s, expf(__fsub_rn(m, v))), 1.0f);
        m = v;
    } else if (v != -INFINITY) {
        s = __fadd_rn(s, expf(__fsub_rn(v, m)));
    }
}

__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
    const float mm = fmaxf(m, m2);
    if (mm == -INFINITY) {
        s = __fadd_rn(s, s2);  // both empty (0), or NaN carried on
    } else {
        s = __fadd_rn(__fmul_rn(s, expf(__fsub_rn(m, mm))),
                      __fmul_rn(s2, expf(__fsub_rn(m2, mm))));
    }
    m = mm;
}

__device__ __forceinline__ float lse_value(float m, float s) {
    if (m == -INFINITY) return s == 0.0f ? -INFINITY : NAN;
    return __fadd_rn(m, logf(s));
}

// log of the mixture density of column j at x, for the calling warp's
// candidate; every thread of the block calls it (it stages the tiles).
__device__ float mixture_logpdf(Comp* tile, const float* __restrict__ mu,
                                const float* __restrict__ sig,
                                const float* __restrict__ logw, int n, int d, int j,
                                float x, bool active, float half_log_2pi) {
    const int lane = threadIdx.x & 31;
    float m = -INFINITY, s = 0.0f;
    for (int t0 = 0; t0 < n; t0 += blockDim.x) {
        __syncthreads();  // every warp is done with the previous tile
        const int i = t0 + threadIdx.x;
        if (i < n) {
            const size_t at = (size_t)i * d + j;
            const float mu_i = mu[at], sig_i = sig[at];
            const float hi = ndtr(__fdiv_rn(__fsub_rn(1.0f, mu_i), sig_i));
            const float lo = ndtr(__fdiv_rn(__fsub_rn(0.0f, mu_i), sig_i));
            float mass = __fsub_rn(hi, lo);
            mass = mass < 1e-12f ? 1e-12f : (mass > 1.0f ? 1.0f : mass);  // NaN stays
            tile[threadIdx.x] = Comp{mu_i, sig_i, logf(sig_i), logf(mass), logw[at]};
        }
        __syncthreads();
        if (active) {
            const int tn = min((int)blockDim.x, n - t0);
            for (int k = lane; k < tn; k += 32) {
                const Comp p = tile[k];
                const float z = __fdiv_rn(__fsub_rn(x, p.mu), p.sig);
                const float log_phi = __fsub_rn(
                    __fsub_rn(__fmul_rn(__fmul_rn(-0.5f, z), z), half_log_2pi), p.log_sig);
                lse_push(m, s, __fadd_rn(__fsub_rn(log_phi, p.log_mass), p.log_w));
            }
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
        const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
        lse_merge(m, s, m2, s2);
    }
    return lse_value(m, s);
}

__global__ void __launch_bounds__(kMaxThreads)
tpe_ei_kernel(const float* __restrict__ cand,
              const float* __restrict__ g_mu, const float* __restrict__ g_sig,
              const float* __restrict__ g_logw,
              const float* __restrict__ b_mu, const float* __restrict__ b_sig,
              const float* __restrict__ b_logw,
              const float* __restrict__ g_cat, const float* __restrict__ b_cat,
              const int* __restrict__ n_choices, const long long* __restrict__ cat_idx,
              const unsigned char* __restrict__ cont,
              float* __restrict__ scores, long long* __restrict__ winners,
              int d, int ng, int nb, int kmax, int n_out, int n_cand,
              float half_log_2pi) {
    __shared__ Comp tile[kMaxThreads];
    const int b = blockIdx.x / n_out, slot = blockIdx.x % n_out;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n_warps = blockDim.x >> 5;
    const size_t C = (size_t)n_out * n_cand;
    const float* cand_b = cand + (size_t)b * C * d;
    const size_t g_at = (size_t)b * ng * d, b_at = (size_t)b * nb * d;
    for (int r0 = 0; r0 < n_cand; r0 += n_warps) {
        const int i = r0 + warp;
        const bool active = i < n_cand;
        const size_t c = (size_t)slot * n_cand + (active ? i : 0);
        float acc = 0.0f;
        for (int j = 0; j < d; ++j) {
            const float x = cand_b[c * d + j];
            float ll, lg;
            if (cont[(size_t)b * d + j]) {  // the same for the whole block
                ll = mixture_logpdf(tile, g_mu + g_at, g_sig + g_at, g_logw + g_at, ng, d, j,
                                    x, active, half_log_2pi);
                lg = mixture_logpdf(tile, b_mu + b_at, b_sig + b_at, b_logw + b_at, nb, d, j,
                                    x, active, half_log_2pi);
            } else {
                long long k_idx;
                if (cat_idx != nullptr) {
                    k_idx = cat_idx[((size_t)b * C + c) * d + j];
                } else {
                    const int k = max(n_choices[(size_t)b * d + j], 1);
                    k_idx = min((long long)__fmul_rn(x, (float)k), (long long)(k - 1));
                }
                k_idx = min(max(k_idx, 0LL), (long long)(kmax - 1));  // never out of the table
                const size_t row = ((size_t)b * d + j) * kmax;
                ll = g_cat[row + k_idx];
                lg = b_cat[row + k_idx];
            }
            acc = __fadd_rn(acc, __fsub_rn(ll, lg));
        }
        if (active && lane == 0) scores[(size_t)b * C + c] = acc;
    }
    if (winners == nullptr) return;
    __syncthreads();  // the slot's scores, written by every warp, are visible
    if (threadIdx.x == 0) {
        const float* s = scores + (size_t)b * C + (size_t)slot * n_cand;
        int best = 0;
        float bv = s[0];
        for (int i = 1; i < n_cand && bv == bv; ++i) {  // a NaN, once found, wins
            const float v = s[i];
            if (v > bv || v != v) {
                best = i;
                bv = v;
            }
        }
        winners[(size_t)b * n_out + slot] = best;
    }
}

}  // namespace

extern "C" {

// cand (B, n_out * n_cand, d); the six component arrays (B, ng or nb, d);
// the tables (B, d, kmax); n_choices (B, d) int32, or cat_idx (B, C, d)
// int64 (n_choices is then not read); cont (B, d), 1 = continuous; scores
// (B, C) out; winners (B, n_out) int64 out, or null for the scores alone.
// All contiguous, float32 unless said. Returns cudaGetLastError().
int tpe_ei(const void* cand, const void* g_mu, const void* g_sig, const void* g_logw,
           const void* b_mu, const void* b_sig, const void* b_logw, const void* g_cat,
           const void* b_cat, const void* n_choices, const void* cat_idx, const void* cont,
           void* scores, void* winners, int B, int d, int ng, int nb, int kmax, int n_out,
           int n_cand, float half_log_2pi, void* stream) {
    const int warps = n_cand < kMaxWarps ? n_cand : kMaxWarps;
    tpe_ei_kernel<<<(unsigned)((long long)B * n_out), 32 * warps, 0, (cudaStream_t)stream>>>(
        (const float*)cand, (const float*)g_mu, (const float*)g_sig, (const float*)g_logw,
        (const float*)b_mu, (const float*)b_sig, (const float*)b_logw, (const float*)g_cat,
        (const float*)b_cat, (const int*)n_choices, (const long long*)cat_idx,
        (const unsigned char*)cont, (float*)scores, (long long*)winners, d, ng, nb, kmax,
        n_out, n_cand, half_log_2pi);
    return (int)cudaGetLastError();
}

}  // extern "C"
