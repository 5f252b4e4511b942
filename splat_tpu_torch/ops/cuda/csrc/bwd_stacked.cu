// Analytic backward of the fused-exposure compositor with the S blur samples
// stacked on the pixel axis: one thread per stacked (sample, pixel) row.
//
// Replaces: scripts_dev/probe_bwd_stacked.py, `bwd_stacked` (body
// `_bwd_kernel_stacked` -> `_bwd_one_tile_stacked`). It computes what
// `rasterize_bwd_packed` computes (rasterize_bwd.cu here): d_params (T, K, 16)
// from the (T, K, 16) blocks, the counts, the forward output and its
// cotangent. What the probe asks about is the mapping: every per-pixel
// quantity is a column of S * npix stacked rows, the early stop is one test
// over all of them, the transmittance and the prefix are carried per stacked
// row, and the per-slot sums over samples and pixels are one reduction over
// all stacked rows. The TPU kernel takes that reduction as matrix products
// with a pixel basis {1, px, py, px^2, px py, py^2} tiled S times and expands
// (px - mx)^2 afterwards, which feeds its matrix unit and cancels in float32;
// here each stacked row forms its twelve terms about the slot's own mean
// (rgb and depth from w; d_sigma; d_sigma times dx, dy, t dx, t dy, dx^2,
// dy^2, dx dy with dx = dx0 - pvx t) and the reduction adds them directly. The
// cumulative-product and prefix matmuls are a sequential recurrence in
// registers, rerun exactly as the forward kernel runs it (same operations,
// same order, -fmad=false), so the live set is the forward's bit for bit.
//
// Bound on this card: rasterize_bwd.cu's, since it is the same function of the
// same inputs: operations, about 5 per live (Gaussian, pixel, sample) for
// sigma, one expf and about 22 per compositing pair, 22 more below the alpha
// clamp, about 23 per live (Gaussian, pixel) for the sigma coefficients. This
// mapping does more than that count: the coefficients are formed once per
// thread and so up to min(S, 1024 / npix) times per pixel, and the reduction's
// 60 shuffles per (Gaussian, warp) are paid for S times as many warps as the
// per-pixel kernel has.
//
// Design: a block of min(S * npix, 1024) threads works through `tps` tiles in
// turn. Thread i owns the stacked rows i, i + blockDim, ... (S = 5 at 16x16 is
// 1280 rows: the first 256 threads own two); blockDim is a multiple of npix,
// so all rows of a thread share one pixel and its sigma coefficients. S is a
// run-time value: one instantiation serves every S up to MAX_ROWS * 1024 /
// npix. Rows are staged 64 at a time in shared memory. The reduction is
// deterministic, with no atomics: each thread adds its own rows in order, a
// warp-shuffle butterfly (skipped when no lane of the warp composited the
// slot), one partial per warp in dynamic shared memory (n_warps x 64 slots x
// 12 sums: 96 KiB for 32 warps, above the 48 KiB default and opted into), and
// one thread per slot adding the warps' partials in a fixed order and
// combining them with the slot's conic and velocity into the 16 output
// columns. The block stops after the batch in which every stacked row's T
// fell to 1e-4 and zeroes the slots it did not reach.
#include <cuda_runtime.h>

namespace {

constexpr int P = 16;          // floats per parameter row (13 used)
constexpr int BATCH = 64;      // rows staged in shared memory at a time
constexpr int NOUT = 5;        // r, g, b, depth_acc, T
constexpr int NSUM = 12;       // per-slot sums reduced over the stacked rows
constexpr int WARP = 32;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_ROWS = 4;    // stacked rows a thread may own
constexpr float LOG_THRESH = -5.541263545158426f;      // log(1/255)
constexpr float LOG_MAX_ALPHA = -0.0010005003335835335f;  // log(0.999)
constexpr float MAX_ALPHA = 0.999f;
constexpr float T_EPS = 1e-4f;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(MAX_THREADS) bwd_stacked_kernel(
    const float* __restrict__ params,   // (T, K, P)
    const int* __restrict__ counts,     // (T,)
    const float* __restrict__ scalars,  // [rs, row_offset, eps_0..eps_{S-1}]
    const float* __restrict__ fwd_out,  // (T, S, NOUT, npix)
    const float* __restrict__ g_out,    // (T, S, NOUT, npix)
    float* __restrict__ d_params,       // (T, K, P)
    int n_tiles, int k, int tile_w, int npix, int tiles_x, float img_h, int n_samples,
    int tps) {
    extern __shared__ float4 smem[];
    float4* stage = smem;                                             // BATCH rows
    float* partial = reinterpret_cast<float*>(smem + BATCH * P / 4);  // [warp][slot][NSUM]
    const float* rows = reinterpret_cast<const float*>(stage);
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int lane = tid % WARP;
    const int warp = tid / WARP;
    const int n_warps = nthreads / WARP;
    const int sp = n_samples * npix;                  // stacked rows of a tile
    const int nrows = (sp - tid + nthreads - 1) / nthreads;   // this thread's, >= 1
    const int p = tid % npix;                         // their pixel
    const int s0 = tid / npix;                        // the first one's sample
    const int s_step = nthreads / npix;
    const int tile_h = npix / tile_w;
    const float px = static_cast<float>(p % tile_w) + 0.5f;   // tile-local centre
    const float py = static_cast<float>(p / tile_w) + 0.5f;
    const float rs = scalars[0];
    const float row_off = scalars[1];

    for (int b = 0; b < tps; ++b) {
        const int t = blockIdx.x * tps + b;
        if (t >= n_tiles) break;
        const float tx = static_cast<float>((t % tiles_x) * tile_w);
        const float ty = static_cast<float>((t / tiles_x) * tile_h);
        const float t_pix = rs * ((py + ty + row_off) / img_h - 0.5f);

        float ts[MAX_ROWS], T[MAX_ROWS], prefix[MAX_ROWS], a_tot[MAX_ROWS];
        float dr[MAX_ROWS], dg[MAX_ROWS], db[MAX_ROWS], dd[MAX_ROWS];
#pragma unroll
        for (int i = 0; i < MAX_ROWS; ++i) {
            ts[i] = 0.0f; T[i] = 0.0f; prefix[i] = 0.0f; a_tot[i] = 0.0f;
            dr[i] = 0.0f; dg[i] = 0.0f; db[i] = 0.0f; dd[i] = 0.0f;
            if (i < nrows) {
                const int s = s0 + i * s_step;
                const long long plane =
                    (static_cast<long long>(t) * n_samples + s) * NOUT * npix + p;
                const float* f = fwd_out + plane;
                const float* c = g_out + plane;
                ts[i] = scalars[2 + s] + t_pix;
                T[i] = 1.0f;
                dr[i] = c[0];
                dg[i] = c[npix];
                db[i] = c[2 * npix];
                dd[i] = c[3 * npix];
                a_tot[i] = f[0] * dr[i] + f[npix] * dg[i] + f[2 * npix] * db[i]
                           + f[3 * npix] * dd[i] + f[4 * npix] * c[4 * npix];
            }
        }

        const int n = min(counts[t], k);
        const float4* src =
            reinterpret_cast<const float4*>(params + static_cast<long long>(t) * k * P);
        float4* dst = reinterpret_cast<float4*>(d_params + static_cast<long long>(t) * k * P);
        int done = 0;
        for (int base = 0; base < n; base += BATCH) {
            const int nb = min(BATCH, n - base);
            __syncthreads();  // the previous batch (or tile) is consumed
            for (int i = tid; i < nb * (P / 4); i += nthreads) stage[i] = src[base * (P / 4) + i];
            __syncthreads();
            for (int j = 0; j < nb; ++j) {
                const float* g = rows + j * P;
                const float mx = g[0] - tx;
                const float my = g[1] - ty;
                const float ca = g[2], cb = g[3], cc = g[4];
                const float pvx = g[10], pvy = g[11], lo_hi = g[12];
                const float dx0 = px - mx;
                const float dy0 = py - my;
                const float A = 0.5f * (ca * dx0 * dx0 + cc * dy0 * dy0) + cb * dx0 * dy0;
                const float B = -(ca * dx0 * pvx + cb * (dx0 * pvy + dy0 * pvx) + cc * dy0 * pvy);
                const float C = 0.5f * (ca * pvx * pvx + cc * pvy * pvy) + cb * pvx * pvy;
                // r, g, b, depth, sum d_sigma, and the d_sigma moments
                // dx, dy, t dx, t dy, dx^2, dy^2, dx dy, over this thread's rows
                float acc[NSUM];
#pragma unroll
                for (int a = 0; a < NSUM; ++a) acc[a] = 0.0f;
                bool hit = false;
#pragma unroll
                for (int i = 0; i < MAX_ROWS; ++i) {
                    if (i < nrows) {
                        const float sigma = A + ts[i] * (B + ts[i] * C);
                        const float lo = lo_hi - sigma;
                        if (T[i] > T_EPS && lo >= LOG_THRESH && lo <= lo_hi) {
                            hit = true;
                            const float alpha = fminf(MAX_ALPHA, expf(lo));
                            const float w = T[i] * alpha;
                            const float v = g[5] * dr[i] + g[6] * dg[i] + g[7] * db[i]
                                            + g[9] * dd[i];
                            const float contrib = w * v;
                            prefix[i] = prefix[i] + contrib;
                            const float suffix = a_tot[i] - prefix[i];
                            acc[0] = acc[0] + w * dr[i];
                            acc[1] = acc[1] + w * dg[i];
                            acc[2] = acc[2] + w * db[i];
                            acc[3] = acc[3] + w * dd[i];
                            if (lo < LOG_MAX_ALPHA) {
                                const float d_sigma = alpha / (1.0f - alpha) * suffix - contrib;
                                const float dx = dx0 - pvx * ts[i];
                                const float dy = dy0 - pvy * ts[i];
                                const float xs = dx * d_sigma;
                                const float ys = dy * d_sigma;
                                acc[4] = acc[4] + d_sigma;
                                acc[5] = acc[5] + xs;
                                acc[6] = acc[6] + ys;
                                acc[7] = acc[7] + ts[i] * xs;
                                acc[8] = acc[8] + ts[i] * ys;
                                acc[9] = acc[9] + dx * xs;
                                acc[10] = acc[10] + dy * ys;
                                acc[11] = acc[11] + dx * ys;
                            }
                            T[i] = T[i] * (1.0f - alpha);
                        }
                    }
                }
                if (__any_sync(FULL, hit)) {
#pragma unroll
                    for (int off = WARP / 2; off > 0; off /= 2) {
#pragma unroll
                        for (int a = 0; a < NSUM; ++a)
                            acc[a] += __shfl_xor_sync(FULL, acc[a], off);
                    }
                }
                if (lane == 0) {
                    float* out = partial + (warp * BATCH + j) * NSUM;
#pragma unroll
                    for (int a = 0; a < NSUM; ++a) out[a] = acc[a];
                }
            }
            __syncthreads();  // every warp's partials of the batch are written
            for (int j = tid; j < nb; j += nthreads) {
                float m[NSUM];
#pragma unroll
                for (int a = 0; a < NSUM; ++a) m[a] = partial[j * NSUM + a];
                for (int wi = 1; wi < n_warps; ++wi) {
                    const float* q = partial + (wi * BATCH + j) * NSUM;
#pragma unroll
                    for (int a = 0; a < NSUM; ++a) m[a] = m[a] + q[a];
                }
                const float* g = rows + j * P;
                const float ca = g[2], cb = g[3], cc = g[4];
                float4* o = dst + (base + j) * (P / 4);
                o[0] = make_float4(-(ca * m[5] + cb * m[6]), -(cc * m[6] + cb * m[5]),
                                   0.5f * m[9], m[11]);
                o[1] = make_float4(0.5f * m[10], m[0], m[1], m[2]);
                o[2] = make_float4(-m[4] / fmaxf(g[8], 1e-12f), m[3],
                                   -(ca * m[7] + cb * m[8]), -(cc * m[8] + cb * m[7]));
                o[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
            done = base + nb;
            bool live = false;
#pragma unroll
            for (int i = 0; i < MAX_ROWS; ++i) live = live || (T[i] > T_EPS);
            if (!__syncthreads_or(live)) break;
        }
        for (int i = done * (P / 4) + tid; i < k * (P / 4); i += nthreads) {
            dst[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
    }
}

}  // namespace

extern "C" int bwd_stacked_f32(const float* params, const int* counts, const float* scalars,
                               const float* fwd_out, const float* g_out, float* d_params,
                               int n_tiles, int k, int tile_w, int tile_h, int tiles_x,
                               float img_h, int n_samples, int tps, void* stream) {
    if (n_tiles == 0) return 0;
    const int npix = tile_w * tile_h;
    const int sp = n_samples * npix;
    const int nthreads = sp < MAX_THREADS ? sp : MAX_THREADS;
    if (n_samples < 1 || tps < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (npix % WARP || nthreads % npix || sp > MAX_ROWS * nthreads)
        return static_cast<int>(cudaErrorInvalidConfiguration);
    const int shared = BATCH * P * 4 + (nthreads / WARP) * BATCH * NSUM * 4;
    if (shared > 48 * 1024) {   // above the default limit: opt in (per device, idempotent)
        cudaError_t err = cudaFuncSetAttribute(
            bwd_stacked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int n_blocks = (n_tiles + tps - 1) / tps;
    bwd_stacked_kernel<<<n_blocks, nthreads, shared, static_cast<cudaStream_t>(stream)>>>(
        params, counts, scalars, fwd_out, g_out, d_params, n_tiles, k, tile_w, npix, tiles_x,
        img_h, n_samples, tps);
    return static_cast<int>(cudaGetLastError());
}
