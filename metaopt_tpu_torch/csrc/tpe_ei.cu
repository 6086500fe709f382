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
// counts as the maximum. Padding components (log w = -inf) add nothing; a
// NaN term makes the mixture NaN; a mixture with no finite term gives
// -inf, as torch.logsumexp does.
//
// What bounds it on an H100. Per candidate, live component and continuous
// column: one exponential on the SFU (16 a clock per SM, 132 SMs: ~4.2e12
// a second at 1980 MHz) and about ten f32 operations (67 TFLOP/s outside
// the tensor cores). At n ~10k (good and bad pads 4096 and 8192, ~10k
// live components), 192 candidates and 2 continuous columns that is ~3.8M
// terms: ~0.9 us of exponentials, ~0.6 us of f32 work. The inputs are
// under 0.6 MB (~0.2 us at 3.35 TB/s) and stay in L2. So the exponentials
// set the bound, and at the main path's sizes the launch's latency sets
// the time. chip_smoke.py computes the bound of each launch it times.
//
// Design. The first kernel of this port (one block per member and output
// slot, one warp per candidate walking every component) ran 200-450x this
// bound: (1) a solo launch filled 8 of 132 SMs and each warp walked all of
// a member's components alone; (2) every term paid an IEEE division and a
// data-dependent branch, and every tile two block barriers; (3) each block
// recomputed every component's truncation mass for every round of
// candidates. This one:
//   1. Splits each (member, slot) over a thread-block cluster along the
//      components axis (item 1). Every CTA of the cluster takes a fixed
//      range of both mixtures' rows (rank r: rows [r * ceil(n / cs), ...)),
//      for every continuous column and all of the slot's candidates. The
//      cluster size cs comes from the pads alone (the wrapper's
//      ei_launch_shape), so small pads spend no CTAs on ranges of nothing;
//      a solo launch at n ~10k runs 8 slots x 8 CTAs. The kernel takes
//      clusters of up to 16, but the wrapper stops at 8: an H100 holds far
//      fewer clusters of 16 at once, and chip_smoke.py times both.
//   2. Merges through distributed shared memory. Each warp leaves one
//      partial log-sum-exp (max m, sum s of exp(v - m)) per (candidate,
//      column, mixture); the CTA merges its warps' in warp order; after
//      cluster.sync() rank 0 reads its peers' (map_shared_rank), takes
//      their maximum, sums the rescaled s in rank order, adds the columns
//      in column order (categorical ones looked up there), writes the
//      scores and takes the slot's argmax (a warp reduction under
//      torch.argmax's order). One launch, no atomics, no global scratch.
//      Partials cover a group of up to kColGroupMax continuous columns at a
//      time, so shared memory does not grow with d.
//   3. Computes each component's constants once per CTA and column (item
//      3): a stage (whole units of up to kTile rows of one column and
//      mixture, as many as fit in kStageMax) is loaded kLoads components a
//      thread at a time, all loads in flight before the first is used, and
//      turned into (mu, sqrt(1/2) / sig, c = -log(2 pi)/2 - log sig - log
//      mass + log w): one reciprocal and one erf pair per component, one
//      block barrier per stage. The candidates' x of the stage's columns
//      come in with cp.async meanwhile. The component arrays are (B, N, d)
//      row-major, so a column is strided by d; the inputs sit in L2, and
//      what the batching hides is the loads' latency.
//   4. Keeps the inner loop cheap and free of data-dependent branches
//      (item 2). A lane owns one or two candidates (x, m, s in registers);
//      the warps of a CTA split each unit into chunks of kChunk components,
//      and all lanes of a warp read a chunk's components from shared memory
//      at once (a broadcast) and update their candidates. A chunk's largest
//      term comes first, then the sum of exp(v - max) by a fixed tree: one
//      rescale per chunk instead of a branch per term. The term is z = (x -
//      mu) * a, v = c - z * z, and exp(v - max) one ex2.approx on the SFU:
//      no division per term.
// No tensor cores: -z*z/2 could be expanded into [x*x, x, 1] . [a, b, c]
// and run as a product, but sig reaches 1/100, so a, b and c reach ~1e4
// and the cancellation costs ~1e-3 in f32 (far more in TF32 or bf16), 100x
// the 1e-5 that the scores are held to.
//
// Determinism. The order of every addition depends only on the member's
// data and the pads (ng, nb): the cluster size, the ranges, the warps and
// their chunks, the trees, the warp and rank orders all come from those,
// and a candidate's arithmetic is the same whichever round or lane holds
// it. It never depends on B, on the member's place in a bucket or on
// timing, and no CTA reads another member's data: a fused bucket row is
// the same bits as the member's solo row, and ei_scores' scores the same
// bits as ei_argmax's.
//
// The wrapper (ops/tpe_math.py::_ei_kernel) passes the launch shape
// (cluster size, candidates per lane, warps); the entry point checks it,
// refuses a cluster that cannot be resident (cudaOccupancyMaxActiveClusters
// says none), launches with cudaLaunchKernelEx and returns the launch's
// error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWarps = 16;               // warps of a CTA
constexpr int kChunk = 8;                   // components a warp takes at a time
constexpr int kTile = 4096;                 // rows of one unit at most
constexpr int kLoads = 4;                   // components a thread loads at a time
constexpr int kStageMax = 6144;             // staged components at most (96 KB)
constexpr int kWarpPartsMax = 65536;        // bytes of the warps' partials at most
constexpr int kColGroupMax = 8;             // continuous columns per cluster merge
constexpr int kMaxCluster = 16;             // non-portable above 8
constexpr int kMaxD = 4096;                 // columns at most (their flags in shared memory)
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kTile % kChunk == 0 && kTile <= kStageMax, "a unit fits a stage");

struct Args {
    const float* cand;                          // (B, C, d)
    const float* mu[2];                         // good, bad: (B, ng or nb, d)
    const float* sig[2];
    const float* logw[2];
    const float* cat[2];                        // (B, d, kmax)
    const int* n_choices;                       // (B, d), or null with cat_idx
    const long long* cat_idx;                   // (B, C, d), or null
    const unsigned char* cont;                  // (B, d), 1 = continuous
    float* scores;                              // (B, C)
    long long* winners;                         // (B, n_out), or null
    int d, n[2], kmax, n_out, n_cand, cluster;
    int stage;                                  // staged components at most
    int group;                                  // continuous columns per merge
    float half_log_2pi;
};

// The dynamic shared memory of a CTA of `warps` warps whose lanes hold K
// candidates each (a round of 32 K candidates), as byte offsets:
//   float4 cst[stage]: (mu, sqrt(1/2) / sig, c, -) per staged component;
//   float2 wpart[warps][group][2][32 K]: each warp's (m, s) per column
//       slot, mixture and candidate;
//   float2 cpart[group][2][32 K]: the CTA's, over its warps (read by rank 0);
//   float merged[group][2][32 K]: rank 0's log l and log g;
//   float xs[group][32 K]: the round's candidates in the group's columns;
//   float sc[32 K]: rank 0's scores of the round;
//   unsigned char cont[d]: the member's continuous columns.
struct Layout {
    size_t wpart, cpart, merged, xs, sc, cont, bytes;
    __host__ __device__ Layout(int stage, int group, int warps, int K, int d) {
        const size_t r = 32 * (size_t)K, g = (size_t)group;
        wpart = sizeof(float4) * stage;
        cpart = wpart + sizeof(float2) * warps * g * 2 * r;
        merged = cpart + sizeof(float2) * g * 2 * r;
        xs = merged + sizeof(float) * g * 2 * r;
        sc = xs + sizeof(float) * g * r;
        cont = sc + sizeof(float) * r;
        bytes = cont + (d + 15) / 16 * 16;
    }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy this thread issued has landed
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 2^x on the SFU, results below 2^-126 flushed to 0 (one instruction)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// torch's float ndtr on the CPU: (1 + erf(x * sqrt(1/2))) * 0.5.
__device__ __forceinline__ float ndtr(float x) {
    return __fmul_rn(__fadd_rn(1.0f, erff(__fmul_rn(x, 0.70710678118654752f))), 0.5f);
}

// The shift of a log-sum-exp whose largest term is m: m, or 0 when no term
// is above -inf (then exp(v - 0) is 0 for -inf and NaN for NaN).
__device__ __forceinline__ float lse_shift(float m) { return m == -INFINITY ? 0.0f : m; }

__device__ __forceinline__ float lse_value(float m, float s) {
    if (m == -INFINITY) return s == 0.0f ? -INFINITY : NAN;
    return __fadd_rn(m, logf(s));
}

// Partials (m_i, s_i) merged in the order given: their largest m, then
// the s_i rescaled to it, summed in that order.
template <class Get>
__device__ __forceinline__ float2 lse_merge(int n, Get get) {
    float mm = -INFINITY;
    for (int i = 0; i < n; ++i) mm = fmaxf(mm, get(i).x);
    const float sh = lse_shift(mm);
    float sum = 0.0f;
    for (int i = 0; i < n; ++i) {
        const float2 p = get(i);
        sum = __fadd_rn(sum, p.x == mm ? p.y : __fmul_rn(p.y, ex2(__fmul_rn(__fsub_rn(p.x, sh), kLog2e))));
    }
    return make_float2(mm, sum);
}

// torch.argmax's order: a NaN beats any number, a larger number a smaller
// one, and of two equals (or two NaNs) the first index wins. A total
// order, so a reduction in any shape picks the same winner.
__device__ __forceinline__ bool beats(float v, int i, float w, int j) {
    const bool vn = v != v, wn = w != w;
    if (vn || wn) return vn && (!wn || i < j);
    return v > w || (v == w && i < j);
}

// log l or log g of a categorical column, as the tables give it.
__device__ __forceinline__ float cat_logp(const Args& a, int b, size_t c, int j, float x,
                                          int mix) {
    const size_t C = (size_t)a.n_out * a.n_cand;
    long long k_idx;
    if (a.cat_idx != nullptr) {
        k_idx = a.cat_idx[((size_t)b * C + c) * a.d + j];
    } else {
        const int k = max(a.n_choices[(size_t)b * a.d + j], 1);
        k_idx = min((long long)__fmul_rn(x, (float)k), (long long)(k - 1));
    }
    k_idx = min(max(k_idx, 0LL), (long long)(a.kmax - 1));  // never out of the table
    return a.cat[mix][((size_t)b * a.d + j) * a.kmax + k_idx];
}

// A unit: up to kTile consecutive rows of this CTA's range of one mixture,
// in one continuous column. The units of a column run good then bad, tile
// by tile; a CTA stages as many whole units as its stage holds.
struct Unit {
    int j, mix, tile;
};

__device__ __forceinline__ bool same(const Unit& u, const Unit& v) {
    return u.j == v.j && u.mix == v.mix && u.tile == v.tile;
}

// One chunk of kChunk staged components (every lane reads the same ones)
// for the lane's K candidates: the chunk's largest term first, then
// exp(v - max) summed by a fixed tree.
template <int K>
__device__ __forceinline__ void score_chunk(const float4* c, const float (&x)[K], float (&m)[K],
                                            float (&s)[K]) {
    float4 p[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) p[q] = c[q];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        float t[kChunk], e[kChunk];
#pragma unroll
        for (int q = 0; q < kChunk; ++q) {
            const float z = __fmul_rn(__fsub_rn(x[k], p[q].x), p[q].y);
            t[q] = __fmaf_rn(-z, z, p[q].z);
            e[q] = t[q];
        }
#pragma unroll
        for (int w = kChunk / 2; w > 0; w /= 2)
#pragma unroll
            for (int q = 0; q < w; ++q) e[q] = fmaxf(e[q], e[q + w]);
        const float mm = fmaxf(m[k], e[0]);
        const float sh = lse_shift(mm);
#pragma unroll
        for (int q = 0; q < kChunk; ++q) e[q] = ex2(__fmul_rn(__fsub_rn(t[q], sh), kLog2e));
#pragma unroll
        for (int w = kChunk / 2; w > 0; w /= 2)
#pragma unroll
            for (int q = 0; q < w; ++q) e[q] = __fadd_rn(e[q], e[q + w]);
        const float kept =
            m[k] == mm ? s[k] : __fmul_rn(s[k], ex2(__fmul_rn(__fsub_rn(m[k], sh), kLog2e)));
        s[k] = __fadd_rn(kept, e[0]);
        m[k] = mm;
    }
}

template <int K>
__global__ void __launch_bounds__(32 * kMaxWarps, 1) tpe_ei_kernel(const Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int R = 32 * K;  // candidates per round
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
    const Layout L(a.stage, a.group, nwarps, K, a.d);
    float4* cst = reinterpret_cast<float4*>(smem);
    float2* wpart = reinterpret_cast<float2*>(smem + L.wpart);
    float2* cpart = reinterpret_cast<float2*>(smem + L.cpart);
    float* merged = reinterpret_cast<float*>(smem + L.merged);
    float* xs = reinterpret_cast<float*>(smem + L.xs);
    float* sc = reinterpret_cast<float*>(smem + L.sc);
    unsigned char* cont = smem + L.cont;

    const int cs = a.cluster;
    const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
    const long long cid = blockIdx.x / cs;
    const int b = (int)(cid / a.n_out), slot = (int)(cid % a.n_out);
    const int d = a.d;
    const size_t C = (size_t)a.n_out * a.n_cand;
    const size_t cand0 = (size_t)b * C + (size_t)slot * a.n_cand;  // the slot's first row
    // a barrier over the cluster (over the CTA when it is alone)
    auto cluster_sync = [&]() {
        if (cs > 1) cg::this_cluster().sync();
        else __syncthreads();
    };
    for (int j = tid; j < d; j += nthreads) cont[j] = a.cont[(size_t)b * d + j];

    // this CTA's range of each mixture's rows (good, bad), and its units
    // per column
    const int per_g = (a.n[0] + cs - 1) / cs, per_b = (a.n[1] + cs - 1) / cs;
    const int row0_g = min(rank * per_g, a.n[0]), row0_b = min(rank * per_b, a.n[1]);
    const int rows_g = min(per_g, a.n[0] - row0_g), rows_b = min(per_b, a.n[1] - row0_b);
    const int tiles_g = max(1, (rows_g + kTile - 1) / kTile);
    const int tiles_b = max(1, (rows_b + kTile - 1) / kTile);
    __syncthreads();  // cont is in
    auto next_cont = [&](int j) {
        while (j < d && !cont[j]) ++j;
        return j;
    };
    auto unit_rows = [&](const Unit& u) {
        return max(0, min(kTile, (u.mix ? rows_b : rows_g) - u.tile * kTile));
    };
    auto unit_len = [&](const Unit& u) { return (unit_rows(u) + kChunk - 1) / kChunk * kChunk; };
    auto next_unit = [&](Unit u) {
        if (++u.tile == (u.mix ? tiles_b : tiles_g)) {
            u.tile = 0;
            if (++u.mix == 2) {
                u.mix = 0;
                u.j = next_cont(u.j + 1);
            }
        }
        return u;
    };

    int best = 0;            // warp 0 of rank 0: the slot's winner so far
    float best_v = 0.0f;
    for (int c0 = 0; c0 < a.n_cand; c0 += R) {
        // rank 0's threads sum the round's candidates' scores over the
        // columns: thread t takes candidates t, t + nthreads (K at most)
        float acc[K];
#pragma unroll
        for (int h = 0; h < K; ++h) acc[h] = 0.0f;
        int col_done = 0;  // columns [0, col_done) are in acc
        // add columns [col_done, upto) in column order: the continuous ones
        // from `merged`, in slot order, the categorical ones from the tables
        auto sum_columns = [&](int upto) {
            if (rank != 0) return;
#pragma unroll
            for (int h = 0; h < K; ++h) {
                const int t = tid + h * nthreads;
                if (t >= R || c0 + t >= a.n_cand) continue;
                int gp = 0;
                for (int j = col_done; j < upto; ++j) {
                    float ll, lg;
                    if (cont[j]) {
                        ll = merged[(gp * 2 + 0) * R + t];
                        lg = merged[(gp * 2 + 1) * R + t];
                        ++gp;
                    } else {
                        const size_t c = (size_t)slot * a.n_cand + c0 + t;
                        const float x = a.cand[((size_t)b * C + c) * d + j];
                        ll = cat_logp(a, b, c, j, x, 0);
                        lg = cat_logp(a, b, c, j, x, 1);
                    }
                    acc[h] = __fadd_rn(acc[h], __fsub_rn(ll, lg));
                }
            }
            col_done = upto;
        };

        // the lane's K candidates (lane, lane + 32, ...): x and (m, s)
        float x[K], m[K], s[K];
        Unit u{next_cont(0), 0, 0};
        int gcols = 0;  // columns of the current group begun so far
        while (u.j < d) {
            // the stage: whole units from u while they fit, within the group
            Unit end = u;
            int used = 0, cols = gcols;
            while (end.j < d) {
                const bool fresh = end.mix == 0 && end.tile == 0;
                if (used + unit_len(end) > a.stage || (fresh && cols == a.group)) break;
                cols += fresh;
                used += unit_len(end);
                end = next_unit(end);
            }
            __syncthreads();  // every warp is done with the last stage's constants
            // the candidates' x of each column begun here, copied in the
            // background while the components are loaded
            {
                int gs = gcols;
                for (Unit v = u; !same(v, end); v = next_unit(v)) {
                    if (v.mix != 0 || v.tile != 0) continue;
                    for (int ci = tid; ci < R; ci += nthreads) {
                        if (c0 + ci < a.n_cand)
                            cp_async4(xs + gs * R + ci, a.cand + (cand0 + c0 + ci) * d + v.j);
                        else
                            xs[gs * R + ci] = 0.5f;
                    }
                    ++gs;
                }
                cp_async_commit();
            }
            // the stage's components: thread t takes flat indices t, t +
            // nthreads, ... (units in order), kLoads at a time, their loads
            // all in flight before the first is used
            {
                Unit v = u;
                int base = 0, len = unit_len(v), rn = unit_rows(v);
                for (int f0 = tid; f0 < used; f0 += kLoads * nthreads) {
                    float mu[kLoads], sg[kLoads], lw[kLoads];
                    bool real[kLoads];
#pragma unroll
                    for (int h = 0; h < kLoads; ++h) {
                        const int f = f0 + h * nthreads;
                        real[h] = false;
                        if (f >= used) continue;
                        while (f >= base + len) {
                            base += len;
                            v = next_unit(v);
                            len = unit_len(v);
                            rn = unit_rows(v);
                        }
                        const int i = f - base;
                        if (i >= rn) continue;
                        const int mix = v.mix;
                        const size_t at = ((size_t)b * a.n[mix] + (mix ? row0_b : row0_g) +
                                           (size_t)v.tile * kTile + i) * d + v.j;
                        mu[h] = __ldg(a.mu[mix] + at);
                        sg[h] = __ldg(a.sig[mix] + at);
                        lw[h] = __ldg(a.logw[mix] + at);
                        real[h] = true;
                    }
#pragma unroll
                    for (int h = 0; h < kLoads; ++h) {
                        const int f = f0 + h * nthreads;
                        if (f >= used) continue;
                        // a padding entry is as a padding row: mu 1/2, sig 1, log w -inf
                        float4 p = make_float4(0.5f, 0.70710678118654752f, -INFINITY, 0.0f);
                        if (real[h]) {
                            const float inv = __frcp_rn(sg[h]);
                            const float hi = ndtr(__fmul_rn(__fsub_rn(1.0f, mu[h]), inv));
                            const float lo = ndtr(__fmul_rn(__fsub_rn(0.0f, mu[h]), inv));
                            float mass = __fsub_rn(hi, lo);
                            mass = mass < 1e-12f ? 1e-12f : (mass > 1.0f ? 1.0f : mass);  // NaN stays
                            const float c = __fadd_rn(
                                __fsub_rn(__fsub_rn(-a.half_log_2pi, logf(sg[h])), logf(mass)),
                                lw[h]);
                            p = make_float4(mu[h], __fmul_rn(0.70710678118654752f, inv), c, 0.0f);
                        }
                        cst[f] = p;
                    }
                }
            }
            cp_async_wait_all();
            __syncthreads();  // the stage's constants and x are in

            // score the stage's units in order; warp w takes chunks w, w +
            // nwarps, ... of each, and keeps its own partial per column and
            // mixture
            int base = 0;
            bool flush = false;
            for (Unit v = u; !same(v, end); v = next_unit(v)) {
                if (v.tile == 0) {
                    if (v.mix == 0) {
#pragma unroll
                        for (int k = 0; k < K; ++k) x[k] = xs[gcols * R + lane + 32 * k];
                        ++gcols;
                    }
#pragma unroll
                    for (int k = 0; k < K; ++k) {
                        m[k] = -INFINITY;
                        s[k] = 0.0f;
                    }
                }
                const int len = unit_len(v);
                for (int o = warp * kChunk; o < len; o += nwarps * kChunk)
                    score_chunk<K>(cst + base + o, x, m, s);
                base += len;
                if (v.tile == (v.mix ? tiles_b : tiles_g) - 1) {
#pragma unroll
                    for (int k = 0; k < K; ++k)
                        wpart[((warp * a.group + gcols - 1) * 2 + v.mix) * R + lane + 32 * k] =
                            make_float2(m[k], s[k]);
                    flush = v.mix == 1 && (gcols == a.group || next_unit(v).j >= d);
                }
            }
            if (flush) {
                __syncthreads();  // every warp's partials of the group are in
                // the CTA's partials: its warps' merged in warp order
                for (int pr = tid; pr < gcols * 2 * R; pr += nthreads)
                    cpart[pr] = lse_merge(nwarps, [&](int w) {
                        return wpart[(size_t)w * a.group * 2 * R + pr];
                    });
                cluster_sync();  // every rank's partials of the group are in
                // rank 0: the ranks' partials merged in rank order
                if (rank == 0) {
                    for (int pr = tid; pr < gcols * 2 * R; pr += nthreads) {
                        const float2 t = lse_merge(cs, [&](int r) {
                            return cs > 1 ? cg::this_cluster().map_shared_rank(cpart, r)[pr]
                                          : cpart[pr];
                        });
                        merged[pr] = lse_value(t.x, t.y);
                    }
                }
                cluster_sync();  // the peers' partials are read; merged is in
                int last = u.j;  // the group's last column: the last unit's
                for (Unit v = u; !same(v, end); v = next_unit(v)) last = v.j;
                sum_columns(last + 1);
                gcols = 0;
            }
            u = end;
        }
        sum_columns(d);  // the categorical columns after the last continuous one
        if (rank == 0) {
#pragma unroll
            for (int h = 0; h < K; ++h) {
                const int t = tid + h * nthreads;
                if (t >= R || c0 + t >= a.n_cand) continue;
                a.scores[cand0 + c0 + t] = acc[h];
                sc[t] = acc[h];
            }
        }
        if (a.winners != nullptr && rank == 0) {
            __syncthreads();  // the round's scores are in sc
            if (warp == 0) {
                const int nc = min(R, a.n_cand - c0);
                int bi = 0x7fffffff;
                float bv = -INFINITY;
                for (int t = lane; t < nc; t += 32)
                    if (beats(sc[t], c0 + t, bv, bi)) {
                        bv = sc[t];
                        bi = c0 + t;
                    }
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) {
                    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
                    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
                    if (beats(ov, oi, bv, bi)) {
                        bv = ov;
                        bi = oi;
                    }
                }
                if (c0 == 0 || beats(bv, bi, best_v, best)) {
                    best_v = bv;
                    best = bi;
                }
            }
            __syncthreads();  // sc is read before the next round writes it
        }
    }
    if (a.winners != nullptr && rank == 0 && tid == 0)
        a.winners[(size_t)b * a.n_out + slot] = best;
}

// The continuous columns of one cluster merge: as many as the warps'
// partials hold, at most kColGroupMax (and d).
int group_size(int d, int warps, int K) {
    const int fit = kWarpPartsMax / (int)(sizeof(float2) * warps * 2 * 32 * K);
    const int g = fit < kColGroupMax ? fit : kColGroupMax;
    return g < d ? (g < 1 ? 1 : g) : d;
}

// The staged components of a launch: whole column groups where they fit,
// at most kStageMax, so that shared memory does not grow with d or n.
int stage_size(int ng, int nb, int cluster, int group) {
    auto padded = [](long long n) { return (n + kChunk - 1) / kChunk * kChunk; };
    const long long col = padded((ng + cluster - 1) / cluster) + padded((nb + cluster - 1) / cluster);
    const long long want = col * group;
    return (int)(want < kChunk ? kChunk : (want > kStageMax ? kStageMax : want));
}

Args with_shape(Args a, int warps, int K) {
    a.group = group_size(a.d, warps, K);
    a.stage = stage_size(a.n[0], a.n[1], a.cluster, a.group);
    return a;
}

template <int K>
cudaError_t configure() {
    static bool done = false;  // the same values every time: a race is harmless
    if (done) return cudaSuccess;
    cudaError_t err =
        cudaFuncSetAttribute(tpe_ei_kernel<K>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    // the most any launch asks for: a full stage, the warps' partials at
    // their cap, and the rest at the largest group and d
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            tpe_ei_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)(Layout(kStageMax, kColGroupMax, 0, K, kMaxD).bytes + kWarpPartsMax));
    done = err == cudaSuccess;
    return err;
}

cudaLaunchConfig_t config(const Args& a, int B, int warps, int K, cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((long long)B * a.n_out * a.cluster), 1, 1);
    cfg.blockDim = dim3(32 * warps, 1, 1);
    cfg.dynamicSmemBytes = Layout(a.stage, a.group, warps, K, a.d).bytes;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = a.cluster > 1 ? 1 : 0;  // a CTA alone needs no cluster
    return cfg;
}

// How many clusters of this shape the card holds at once, or minus a
// cudaError_t.
template <int K>
int max_active_clusters(const Args& a, int warps) {
    cudaError_t err = configure<K>();
    if (err != cudaSuccess) return -(int)err;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config(a, 1, warps, K, attr);
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, tpe_ei_kernel<K>, &cfg);
    return err != cudaSuccess ? -(int)err : clusters;
}

// One launch: the attributes, the residency check, cudaLaunchKernelEx and
// its error.
template <int K>
int launch(const Args& a, int B, int warps, cudaStream_t stream) {
    if (a.cluster > 1) {
        // the CTAs of a cluster run together on one GPC: refuse a shape
        // that cannot be resident
        const int clusters = max_active_clusters<K>(a, warps);
        if (clusters < 0) return -clusters;
        if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    } else {
        const cudaError_t err = configure<K>();
        if (err != cudaSuccess) return (int)err;
    }
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config(a, B, warps, K, attr);
    cfg.stream = stream;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, tpe_ei_kernel<K>, a);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

bool valid_shape(int d, int ng, int nb, int cluster, int k, int warps) {
    return d >= 1 && d <= kMaxD && ng >= 0 && nb >= 0 && cluster >= 1 &&
           cluster <= kMaxCluster && (cluster & (cluster - 1)) == 0 && (k == 1 || k == 2) &&
           warps >= 1 && warps <= kMaxWarps;
}

Args shape_args(int d, int ng, int nb, int cluster, int k, int warps) {
    Args a = {};
    a.d = d;
    a.n[0] = ng;
    a.n[1] = nb;
    a.n_out = 1;
    a.cluster = cluster;
    return with_shape(a, warps, k);
}

}  // namespace

extern "C" {

const char* tpe_ei_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// How many clusters of this launch shape the card holds at once (what
// cudaOccupancyMaxActiveClusters says), or minus a cudaError_t.
int tpe_ei_max_active_clusters(int d, int ng, int nb, int cluster, int k, int warps) {
    if (!valid_shape(d, ng, nb, cluster, k, warps)) return -(int)cudaErrorInvalidValue;
    const Args a = shape_args(d, ng, nb, cluster, k, warps);
    return k == 1 ? max_active_clusters<1>(a, warps) : max_active_clusters<2>(a, warps);
}

// cand (B, n_out * n_cand, d); the six component arrays (B, ng or nb, d);
// the tables (B, d, kmax); n_choices (B, d) int32, or cat_idx (B, C, d)
// int64 (n_choices is then not read); cont (B, d), 1 = continuous; scores
// (B, C) out; winners (B, n_out) int64 out, or null for the scores alone.
// All contiguous, float32 unless said. The launch shape: clusters of
// `cluster` CTAs (1, 2, 4, 8 or 16), each of `warps` warps whose lanes hold k
// candidates (1 or 2) each. Returns a cudaError_t: 0, or why the launch
// was refused or failed.
int tpe_ei(const void* cand, const void* g_mu, const void* g_sig, const void* g_logw,
           const void* b_mu, const void* b_sig, const void* b_logw, const void* g_cat,
           const void* b_cat, const void* n_choices, const void* cat_idx, const void* cont,
           void* scores, void* winners, int B, int d, int ng, int nb, int kmax, int n_out,
           int n_cand, int cluster, int k, int warps, float half_log_2pi, void* stream) {
    if (B < 1 || kmax < 1 || n_out < 1 || n_cand < 1 || !valid_shape(d, ng, nb, cluster, k, warps))
        return (int)cudaErrorInvalidValue;
    Args a = shape_args(d, ng, nb, cluster, k, warps);
    a.cand = (const float*)cand;
    a.mu[0] = (const float*)g_mu;
    a.sig[0] = (const float*)g_sig;
    a.logw[0] = (const float*)g_logw;
    a.mu[1] = (const float*)b_mu;
    a.sig[1] = (const float*)b_sig;
    a.logw[1] = (const float*)b_logw;
    a.cat[0] = (const float*)g_cat;
    a.cat[1] = (const float*)b_cat;
    a.n_choices = (const int*)n_choices;
    a.cat_idx = (const long long*)cat_idx;
    a.cont = (const unsigned char*)cont;
    a.scores = (float*)scores;
    a.winners = (long long*)winners;
    a.kmax = kmax;
    a.n_out = n_out;
    a.n_cand = n_cand;
    a.half_log_2pi = half_log_2pi;
    return k == 1 ? launch<1>(a, B, warps, (cudaStream_t)stream)
                  : launch<2>(a, B, warps, (cudaStream_t)stream);
}

}  // extern "C"
