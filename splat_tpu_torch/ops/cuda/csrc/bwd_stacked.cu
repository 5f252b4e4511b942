// Analytic backward of the fused-exposure compositor with the S blur samples
// stacked on the pixel axis: every thread owns R stacked (sample, pixel) rows.
//
// Replaces: scripts_dev/probe_bwd_stacked.py, `bwd_stacked` (body
// `_bwd_kernel_stacked` -> `_bwd_one_tile_stacked`). It computes what
// `rasterize_bwd_packed` computes (rasterize_bwd.cu here): d_params (T, K, 16)
// from the (T, K, 16) blocks, the counts, the forward output and its
// cotangent. What the probe asks about is the mapping: every per-pixel
// quantity is a column of S * npix stacked rows (row s * npix + p), the early
// stop covers all of them, the transmittance and the prefix are carried per
// stacked row, and the per-slot sums over samples and pixels are one
// reduction over all stacked rows. The TPU kernel takes that reduction as
// matrix products with a pixel basis {1, px, py, px^2, px py, py^2} tiled S
// times and expands (px - mx)^2 afterwards, which feeds its matrix unit and
// cancels in float32; here each stacked row forms its twelve terms about the
// slot's own mean (rgb and depth from w; d_sigma; d_sigma times dx, dy, t dx,
// t dy, dx^2, dy^2, dx dy with dx = dx0 - pvx t) and the reduction adds them.
// The cumulative-product and prefix matmuls are a sequential recurrence in
// registers, rerun exactly as the forward kernel runs it (same operations,
// same order, -fmad=false), so the live set is the forward's bit for bit;
// only the twelve accumulations are contracted (__fmaf_rn), as in
// rasterize_bwd.cu.
//
// Bound on this card: rasterize_bwd.cu's, since it is the same function of the
// same inputs (operations; chip_smoke.py phase 7 counts them). This mapping
// does more than that count: the sigma coefficients A and B are formed once
// per distinct pixel of a thread's rows rather than once per pixel, and the
// per-slot sum is reduced over the tile's S * npix / (32 R) warps rather
// than its npix / 32.
//
// Design. A block works through `tps` tiles in turn. The tile's stacked rows
// fall into NG = S * npix / 32 groups of 32 (one sample's 32 pixels of one
// pixel strip); the block has NG / R warps, and every thread owns R rows, the
// same R for all (balance). R is a launch argument (1 to 4, dividing NG into
// at most 32 warps), chosen by the wrapper (`stacked_layout` in
// ../bwd_stacked.py): the least that keeps the block at <= 16 warps, else
// at <= 32: at S = 5 and 16x16 tiles 10 warps of 4 rows, which
// the launch bounds fit three blocks an SM (30 warps); 20 warps of 2 rows fit
// one (their registers: 89 a thread) and were slower on the H100 (PERF.md
// §6). Groups are taken in strip-major order (strip k, sample s is
// group k * S + s) and warp w owns groups w R .. w R + R - 1, so a thread's
// rows share one pixel wherever R of a strip's samples fall in one warp (at
// S = 5, R = 4: a thread's rows span one strip in 4 of the 10 warps, two in
// the rest), and a thread forms A and B once per distinct pixel of its rows.
// S and R are template parameters, so the rows' state (t, T, prefix,
// A_total and the four cotangents) stays in registers.
//
// The cull is per sample: the per-row pass (raster_common.cuh `row_pass`,
// one item per (row, sample)) takes each row's swept box over one sample's
// rolling-shutter range only (`make_tile` over samples [s, s + 1)), inside the
// box over the whole exposure that the compositors use, and tests it against
// every pixel strip: bit (s, strip) clear means no pixel of that group can
// composite the row, so a warp skips each of its groups whose bit is clear,
// and a row altogether when all are (`sample_hit_mask` beside
// `warp_hit_mask` in ../rasterize_kernels.py is its plain version). Rows are
// staged by cp.async into two shared buffers, batch b + 1 in flight while
// batch b is processed. A warp whose rows all have T <= 1e-4 skips the next
// batches; the block stops after the batch in which every warp has, and
// zeroes the slots it did not reach.
//
// The sum over a warp's lanes is raster_common.cuh's 16-shuffle
// transpose-reduce of the thread's twelve terms (already summed over its R
// rows in row order); a warp where no lane composited skips it and writes
// nothing, the others set their bit in the row's 32-bit `wrote` word. The
// combine is spread over the block, one thread per (slot, output column): it
// adds the one or two sums its column needs over the warps that wrote, in
// warp order (deterministic: no float atomics; the same for every tps), and
// writes the column. The partials take n_warps x 64 x 13 floats of dynamic
// shared memory (33,280 bytes at 10 warps). A warp lists the rows of a
// batch it keeps (two ballots over the per-sample masks) and visits only
// those.
#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr int STACK_MAX_THREADS = 1024;
constexpr int MAX_TILE_PIXELS = MAX_THREADS;   // the compositors' tile limit
constexpr int PSTRIDE = 13;    // floats per partial (odd: no bank conflicts in the combine)
constexpr float LOG_MAX_ALPHA = -0.0010005003335835335f;  // log(0.999)
static_assert(BATCH == 2 * WARP, "a warp lists a batch's rows in two ballots");

// The launch bounds of S samples and R rows a thread: the threads of a
// 256-pixel tile (at most 1024), and as many blocks an SM as 1024 threads
// make, up to 3: at S = 5, R = 4, 3 blocks of 320 threads and 64 registers
// a thread, with 240 bytes of spill (measured faster on the H100 than 2
// blocks at 96 registers, 1.84 against 1.95 ms: PERF.md §6).
__host__ __device__ constexpr int max_threads(int S, int R) {
    return S * MAX_TILE_PIXELS / R < STACK_MAX_THREADS ? S * MAX_TILE_PIXELS / R
                                                       : STACK_MAX_THREADS;
}
__host__ __device__ constexpr int min_blocks(int S, int R) {
    return max_threads(S, R) <= STACK_MAX_THREADS / 3 ? 3
           : max_threads(S, R) <= STACK_MAX_THREADS / 2 ? 2 : 1;
}

template <int S, int R>
__global__ void __launch_bounds__(max_threads(S, R), min_blocks(S, R)) bwd_stacked_kernel(
    const float* __restrict__ params,   // (T, K, P)
    const int* __restrict__ counts,     // (T,)
    const float* __restrict__ scalars,  // [rs, row_offset, eps_0..eps_{S-1}]
    const float* __restrict__ fwd_out,  // (T, S, NOUT, npix)
    const float* __restrict__ g_out,    // (T, S, NOUT, npix)
    float* __restrict__ d_params,       // (T, K, P)
    int n_tiles, int k, int tile_w, int npix, int tiles_x, float img_h, int tps) {
    __shared__ Staging<S> st;
    __shared__ unsigned wrote[BATCH];
    extern __shared__ float partial[];   // [warp][slot][PSTRIDE]
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int lane = tid % WARP;
    const int warp = tid / WARP;
    const float rs = scalars[0];
    const float row_off = scalars[1];
    // this thread's rows: group warp * R + i is strip g / S, sample g % S
    int strip[R], samp[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int g = warp * R + i;
        strip[i] = g / S;
        samp[i] = g - strip[i] * S;
    }

    for (int b = 0; b < tps; ++b) {
        const int t = blockIdx.x * tps + b;
        if (t >= n_tiles) break;
        __syncthreads();   // the previous tile's rows and partials are consumed
        if (tid < S) st.tile[tid] = make_tile(t, npix, tile_w, tiles_x, img_h, scalars, tid, tid + 1);
        const float ty = static_cast<float>((t / tiles_x) * (npix / tile_w));

        float ts[R], T[R], prefix[R], a_tot[R], dr[R], dg[R], db[R], dd[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
            const int p = strip[i] * WARP + lane;
            const float py = static_cast<float>(p / tile_w) + 0.5f;
            const float t_pix = rs * ((py + ty + row_off) / img_h - 0.5f);
            const long long plane = (static_cast<long long>(t) * S + samp[i]) * NOUT * npix + p;
            const float* f = fwd_out + plane;
            const float* c = g_out + plane;
            ts[i] = scalars[2 + samp[i]] + t_pix;
            T[i] = 1.0f;
            prefix[i] = 0.0f;
            dr[i] = c[0];
            dg[i] = c[npix];
            db[i] = c[2 * npix];
            dd[i] = c[3 * npix];
            a_tot[i] = f[0] * dr[i] + f[npix] * dg[i] + f[2 * npix] * db[i]
                       + f[3 * npix] * dd[i] + f[4 * npix] * c[4 * npix];
        }

        const int n = min(counts[t], k);
        const float4* src = reinterpret_cast<const float4*>(params + static_cast<long long>(t) * k * P);
        float* dst = d_params + static_cast<long long>(t) * k * P;
        if (n > 0) stage_rows(st.rows[0], src, min(BATCH, n), tid, nthreads);
        bool live = true;
        bool warp_live = true;
        int done = 0;
        int buf = 0;
        for (int base = 0; base < n; base += BATCH, buf ^= 1) {
            const int nb = min(BATCH, n - base);
            stage_wait();
            // batch b has landed; batch b - 1's buffer, per-row values and
            // partials are consumed
            if (!__syncthreads_or(live)) break;
            if (base + BATCH < n) {
                stage_rows(st.rows[buf ^ 1], src + (base + BATCH) * P4,
                           min(BATCH, n - base - BATCH), tid, nthreads);
            }
            row_pass(st, buf, nb, tid, nthreads);
            for (int j = tid; j < nb; j += nthreads) wrote[j] = 0u;
            __syncthreads();
            // the rows this warp keeps: lane l reads rows l and l + 32 of the
            // batch (bit i: the warp's group i keeps the row), a ballot lists
            // them, and the warp visits only those
            unsigned nib[2];   // BATCH = 2 * WARP rows
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int j = lane + h * WARP;
                nib[h] = 0u;
#pragma unroll
                for (int i = 0; i < R; ++i) {
                    if (j < nb) nib[h] |= ((st.mask[j][samp[i]] >> strip[i]) & 1u) << i;
                }
            }
            const unsigned long long todo_all =
                warp_live ? __ballot_sync(FULL, nib[0] != 0u)
                                | static_cast<unsigned long long>(__ballot_sync(FULL, nib[1] != 0u)) << WARP
                          : 0ull;
            for (unsigned long long todo = todo_all; todo; todo &= todo - 1ull) {
                const int j = __ffsll(static_cast<long long>(todo)) - 1;
                const unsigned kept = __shfl_sync(FULL, j < WARP ? nib[0] : nib[1], j % WARP);
                const float4* g = st.rows[buf] + j * P4;
                const float4 g0 = g[0], g1 = g[1], g2 = g[2];
                const float4 rv = st.rowv[j];
                const float ca = g0.z, cb = g0.w, cc = g1.x;
                const float pvx = g2.z, pvy = g2.w, lo_hi = rv.w;
                const float C = rv.z;
                // r, g, b, depth, sum d_sigma, and the d_sigma moments
                // dx, dy, t dx, t dy, dx^2, dy^2, dx dy; padded to NRED
                float acc[NRED];
#pragma unroll
                for (int a = 0; a < NRED; ++a) acc[a] = 0.0f;
                bool hit = false;
                int ab_strip = -1;   // the strip whose A and B are formed
                float dx0 = 0.0f, dy0 = 0.0f, A = 0.0f, B = 0.0f;
#pragma unroll
                for (int i = 0; i < R; ++i) {
                    if (!((kept >> i) & 1u)) continue;   // warp-uniform
                    if (strip[i] != ab_strip) {
                        const int p = strip[i] * WARP + lane;
                        dx0 = (static_cast<float>(p % tile_w) + 0.5f) - rv.x;
                        dy0 = (static_cast<float>(p / tile_w) + 0.5f) - rv.y;
                        A = 0.5f * (ca * dx0 * dx0 + cc * dy0 * dy0) + cb * dx0 * dy0;
                        B = -(ca * dx0 * pvx + cb * (dx0 * pvy + dy0 * pvx) + cc * dy0 * pvy);
                        ab_strip = strip[i];
                    }
                    const float sigma = A + ts[i] * (B + ts[i] * C);
                    const float lo = lo_hi - sigma;
                    if (T[i] > T_EPS && lo >= LOG_THRESH && lo <= lo_hi) {
                        hit = true;
                        const float alpha = fminf(MAX_ALPHA, expf(lo));
                        const float w = T[i] * alpha;
                        const float v = g1.y * dr[i] + g1.z * dg[i] + g1.w * db[i] + g2.y * dd[i];
                        const float contrib = w * v;
                        prefix[i] = prefix[i] + contrib;
                        const float suffix = a_tot[i] - prefix[i];
                        acc[0] = __fmaf_rn(w, dr[i], acc[0]);
                        acc[1] = __fmaf_rn(w, dg[i], acc[1]);
                        acc[2] = __fmaf_rn(w, db[i], acc[2]);
                        acc[3] = __fmaf_rn(w, dd[i], acc[3]);
                        if (lo < LOG_MAX_ALPHA) {
                            const float d_sigma = alpha / (1.0f - alpha) * suffix - contrib;
                            const float dx = dx0 - pvx * ts[i];
                            const float dy = dy0 - pvy * ts[i];
                            const float xs = dx * d_sigma;
                            const float ys = dy * d_sigma;
                            acc[4] = acc[4] + d_sigma;
                            acc[5] = acc[5] + xs;
                            acc[6] = acc[6] + ys;
                            acc[7] = __fmaf_rn(ts[i], xs, acc[7]);
                            acc[8] = __fmaf_rn(ts[i], ys, acc[8]);
                            acc[9] = __fmaf_rn(dx, xs, acc[9]);
                            acc[10] = __fmaf_rn(dy, ys, acc[10]);
                            acc[11] = __fmaf_rn(dx, ys, acc[11]);
                        }
                        T[i] = T[i] * (1.0f - alpha);
                    }
                }
                if (__any_sync(FULL, hit)) {   // warp-uniform
                    const float sum = transpose_reduce(acc, lane);
                    const int idx = lane >> 1;
                    if (!(lane & 1) && idx < NACC) partial[(warp * BATCH + j) * PSTRIDE + idx] = sum;
                    if (lane == 0) atomicOr(&wrote[j], 1u << warp);
                }
            }
            __syncthreads();  // every warp's partials of the batch are written
            // one thread per (slot, output column): the sums it needs, over
            // the warps that wrote, in warp order
            for (int item = tid; item < nb * P; item += nthreads) {
                const int j = item / P;
                const int col = item - j * P;
                int ia = -1, ib = -1;   // the sums column col combines (-1: none)
                switch (col) {
                    case 0: case 1: ia = 5; ib = 6; break;
                    case 2: ia = 9; break;
                    case 3: ia = 11; break;
                    case 4: ia = 10; break;
                    case 5: case 6: case 7: ia = col - 5; break;
                    case 8: ia = 4; break;
                    case 9: ia = 3; break;
                    case 10: case 11: ia = 7; ib = 8; break;
                    default: break;
                }
                float ma = 0.0f, mb = 0.0f;
                if (ia >= 0) {
                    for (unsigned bits = wrote[j]; bits; bits &= bits - 1u) {   // in warp order
                        const float* q = partial + ((__ffs(bits) - 1) * BATCH + j) * PSTRIDE;
                        ma = ma + q[ia];
                        if (ib >= 0) mb = mb + q[ib];
                    }
                }
                const float* g = reinterpret_cast<const float*>(st.rows[buf] + j * P4);
                const float ca = g[2], cb = g[3], cc = g[4];
                float out;
                switch (col) {
                    case 0: out = -(ca * ma + cb * mb); break;    // mean x: sums 5, 6
                    case 1: out = -(cc * mb + cb * ma); break;    // mean y
                    case 2: out = 0.5f * ma; break;               // conic a: sum 9
                    case 3: out = ma; break;                      // conic b: sum 11
                    case 4: out = 0.5f * ma; break;               // conic c: sum 10
                    case 8: out = -ma / fmaxf(g[8], 1e-12f); break;   // opacity: sum 4
                    case 10: out = -(ca * ma + cb * mb); break;   // velocity x: sums 7, 8
                    case 11: out = -(cc * mb + cb * ma); break;   // velocity y
                    default: out = ma; break;                     // rgb, depth; 0 past 11
                }
                dst[(base + j) * P + col] = out;
            }
            done = base + nb;
            live = false;
#pragma unroll
            for (int i = 0; i < R; ++i) live = live || T[i] > T_EPS;
            warp_live = __any_sync(FULL, live);
        }
        float4* dst4 = reinterpret_cast<float4*>(dst);
        for (int i = done * P4 + tid; i < k * P4; i += nthreads) {
            dst4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
    }
}

template <int S, int R>
int launch(const float* params, const int* counts, const float* scalars, const float* fwd_out,
           const float* g_out, float* d_params, int n_tiles, int k, int tile_w, int npix,
           int tiles_x, float img_h, int tps, cudaStream_t stream) {
    const int nthreads = S * npix / R;
    if ((S * npix / WARP) % R || nthreads > max_threads(S, R))
        return static_cast<int>(cudaErrorInvalidConfiguration);
    const int shared = (nthreads / WARP) * BATCH * PSTRIDE * static_cast<int>(sizeof(float));
    const cudaError_t err = allow_dynamic_smem<bwd_stacked_kernel<S, R>>(shared);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_blocks = (n_tiles + tps - 1) / tps;
    bwd_stacked_kernel<S, R><<<n_blocks, nthreads, shared, stream>>>(
        params, counts, scalars, fwd_out, g_out, d_params, n_tiles, k, tile_w, npix, tiles_x,
        img_h, tps);
    return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_rows(int rows, const float* params, const int* counts, const float* scalars,
                const float* fwd_out, const float* g_out, float* d_params, int n_tiles, int k,
                int tile_w, int npix, int tiles_x, float img_h, int tps, cudaStream_t stream) {
    switch (rows) {
        case 1: return launch<S, 1>(params, counts, scalars, fwd_out, g_out, d_params, n_tiles, k,
                                    tile_w, npix, tiles_x, img_h, tps, stream);
        case 2: return launch<S, 2>(params, counts, scalars, fwd_out, g_out, d_params, n_tiles, k,
                                    tile_w, npix, tiles_x, img_h, tps, stream);
        case 3: return launch<S, 3>(params, counts, scalars, fwd_out, g_out, d_params, n_tiles, k,
                                    tile_w, npix, tiles_x, img_h, tps, stream);
        case 4: return launch<S, 4>(params, counts, scalars, fwd_out, g_out, d_params, n_tiles, k,
                                    tile_w, npix, tiles_x, img_h, tps, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// rows: the stacked rows each thread owns (1 to 4, dividing the tile's
// S * npix / 32 groups into at most 32 warps).
extern "C" int bwd_stacked_f32(const float* params, const int* counts, const float* scalars,
                               const float* fwd_out, const float* g_out, float* d_params,
                               int n_tiles, int k, int tile_w, int tile_h, int tiles_x,
                               float img_h, int n_samples, int tps, int rows, void* stream) {
    if (n_tiles == 0) return 0;
    const int npix = tile_w * tile_h;
    if (tps < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (npix % WARP || npix > MAX_TILE_PIXELS) return static_cast<int>(cudaErrorInvalidConfiguration);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SPLAT_CASE(N)                                                                      \
    case N:                                                                                \
        return launch_rows<N>(rows, params, counts, scalars, fwd_out, g_out, d_params,    \
                              n_tiles, k, tile_w, npix, tiles_x, img_h, tps, s);
    switch (n_samples) {
        SPLAT_CASE(1) SPLAT_CASE(2) SPLAT_CASE(3) SPLAT_CASE(4)
        SPLAT_CASE(5) SPLAT_CASE(6) SPLAT_CASE(7) SPLAT_CASE(8)
        SPLAT_CASE(9) SPLAT_CASE(10) SPLAT_CASE(11) SPLAT_CASE(12)
        SPLAT_CASE(13) SPLAT_CASE(14) SPLAT_CASE(15) SPLAT_CASE(16)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef SPLAT_CASE
}
