// Analytic backward of the fused-exposure compositor: every tile, every blur
// sub-frame, per-slot gradients summed over samples and pixels.
//
// Replaces: splat_tpu/ops/pallas/rasterize_kernels.py, `rasterize_bwd_packed`
// (body `_bwd_kernel` -> `_bwd_one_tile`). It computes what that kernel
// computes, not its block structure: per tile, one front-to-back pass over
// <= K depth-sorted Gaussians that reruns the forward recurrence of
// rasterize_fwd.cu (same operations in the same order, so T and the live set
// are the forward's bit for bit), and recovers the suffix each alpha needs as
// A_total - prefix_inclusive, with A_total = rgb.dC + depth_acc dD + T_final dT
// read from the forward output. Per (slot, pixel, sample) where the forward
// composited: w = T alpha, v = c.dC + d dD, and, below the alpha clamp,
// d_sigma = alpha / (1 - alpha) * suffix - w v. Output d_params (T, K, 16):
// columns 0-11 the gradients of mean x/y, conic a/b/c, rgb, opacity, depth and
// pixel velocity x/y; column 12 (log opacity) and 13-15 zero; every slot past
// the tile's count or its early stop zero.
//
// Bound on this card: operations. Each live (Gaussian, pixel, sample) costs
// about 5 FP32 operations for sigma; each pair that composites one expf and
// about 22 more (the forward step, the prefix and suffix, the colour terms),
// and below the alpha clamp 22 more (one division and the eight d_sigma
// moments); each live (Gaussian, pixel) about 23 for the sigma coefficients.
// Not counted in the bound: the 60 shuffles per (Gaussian, warp) that order
// the per-slot sums. The bytes (the rows once, two (T, S, 5, npix) planes in,
// the (T, K, 16) gradients out) are small beside that.
//
// Design: one block per tile, one thread per pixel, rows staged 64 at a time
// in shared memory as in the forward kernel, S a template parameter so the
// per-sample state (t, T, prefix, A_total and the four cotangents) stays in
// registers. The TPU kernel's moment planes and pixel-basis matmuls exist to
// feed the MXU; here each thread sums its twelve terms (rgb and depth from w,
// sum d_sigma, and the d_sigma-weighted moments dx, dy, t dx, t dy, dx^2,
// dy^2, dx dy with dx = dx0 - pvx t) over the samples in registers. The
// per-slot sum over pixels is deterministic, with no atomics: a warp-shuffle
// butterfly (skipped when no lane of the warp composited the slot), one
// partial per warp in shared memory, then one thread per slot adds the warps'
// partials in a fixed order and combines the moments with the slot's conic
// and velocity into the 16 output columns. The block stops after the batch in
// which every pixel's T fell to 1e-4 for every sample, as the forward does,
// and zeroes the slots it did not reach. Built with -fmad=false like the
// forward kernel, so the rerun recurrence matches it exactly.
#include <cuda_runtime.h>

namespace {

constexpr int P = 16;          // floats per parameter row (13 used)
constexpr int BATCH = 64;      // rows staged in shared memory at a time
constexpr int NOUT = 5;        // r, g, b, depth_acc, T
constexpr int NACC = 12;       // per-slot sums reduced over pixels
constexpr int WARP = 32;
constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / WARP;
constexpr float LOG_THRESH = -5.541263545158426f;      // log(1/255)
constexpr float LOG_MAX_ALPHA = -0.0010005003335835335f;  // log(0.999)
constexpr float MAX_ALPHA = 0.999f;
constexpr float T_EPS = 1e-4f;
constexpr unsigned FULL = 0xffffffffu;

template <int S>
__global__ void __launch_bounds__(MAX_THREADS) rasterize_bwd_kernel(
    const float* __restrict__ params,   // (T, K, P)
    const int* __restrict__ counts,     // (T,)
    const float* __restrict__ scalars,  // [rs, row_offset, eps_0..eps_{S-1}]
    const float* __restrict__ fwd_out,  // (T, S, NOUT, npix)
    const float* __restrict__ g_out,    // (T, S, NOUT, npix)
    float* __restrict__ d_params,       // (T, K, P)
    int k, int tile_w, int tiles_x, float img_h) {
    __shared__ float4 stage[BATCH * P / 4];
    __shared__ float partial[MAX_WARPS][BATCH][NACC];
    const int t = blockIdx.x;
    const int p = threadIdx.x;
    const int npix = blockDim.x;
    const int lane = p % WARP;
    const int warp = p / WARP;
    const int n_warps = npix / WARP;
    const int tile_h = npix / tile_w;
    const float tx = static_cast<float>((t % tiles_x) * tile_w);
    const float ty = static_cast<float>((t / tiles_x) * tile_h);
    const float px = static_cast<float>(p % tile_w) + 0.5f;
    const float py = static_cast<float>(p / tile_w) + 0.5f;
    const float rs = scalars[0];
    const float row_off = scalars[1];
    const float t_pix = rs * ((py + ty + row_off) / img_h - 0.5f);

    float ts[S], T[S], prefix[S], a_tot[S], dr[S], dg[S], db[S], dd[S];
    const long long plane = static_cast<long long>(t) * S * NOUT * npix + p;
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const float* f = fwd_out + plane + s * NOUT * npix;
        const float* c = g_out + plane + s * NOUT * npix;
        ts[s] = scalars[2 + s] + t_pix;
        T[s] = 1.0f;
        prefix[s] = 0.0f;
        dr[s] = c[0];
        dg[s] = c[npix];
        db[s] = c[2 * npix];
        dd[s] = c[3 * npix];
        a_tot[s] = f[0] * dr[s] + f[npix] * dg[s] + f[2 * npix] * db[s]
                   + f[3 * npix] * dd[s] + f[4 * npix] * c[4 * npix];
    }

    const int n = min(counts[t], k);
    const float4* src = reinterpret_cast<const float4*>(params + static_cast<long long>(t) * k * P);
    float4* dst = reinterpret_cast<float4*>(d_params + static_cast<long long>(t) * k * P);
    const float* rows = reinterpret_cast<const float*>(stage);
    int done = 0;
    for (int base = 0; base < n; base += BATCH) {
        const int nb = min(BATCH, n - base);
        __syncthreads();  // the previous batch is consumed
        for (int i = p; i < nb * (P / 4); i += npix) stage[i] = src[base * (P / 4) + i];
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
            // dx, dy, t dx, t dy, dx^2, dy^2, dx dy
            float acc[NACC];
#pragma unroll
            for (int a = 0; a < NACC; ++a) acc[a] = 0.0f;
            bool hit = false;
#pragma unroll
            for (int s = 0; s < S; ++s) {
                const float sigma = A + ts[s] * (B + ts[s] * C);
                const float lo = lo_hi - sigma;
                if (T[s] > T_EPS && lo >= LOG_THRESH && lo <= lo_hi) {
                    hit = true;
                    const float alpha = fminf(MAX_ALPHA, expf(lo));
                    const float w = T[s] * alpha;
                    const float v = g[5] * dr[s] + g[6] * dg[s] + g[7] * db[s] + g[9] * dd[s];
                    const float contrib = w * v;
                    prefix[s] = prefix[s] + contrib;
                    const float suffix = a_tot[s] - prefix[s];
                    acc[0] = acc[0] + w * dr[s];
                    acc[1] = acc[1] + w * dg[s];
                    acc[2] = acc[2] + w * db[s];
                    acc[3] = acc[3] + w * dd[s];
                    if (lo < LOG_MAX_ALPHA) {
                        const float d_sigma = alpha / (1.0f - alpha) * suffix - contrib;
                        const float dx = dx0 - pvx * ts[s];
                        const float dy = dy0 - pvy * ts[s];
                        const float xs = dx * d_sigma;
                        const float ys = dy * d_sigma;
                        acc[4] = acc[4] + d_sigma;
                        acc[5] = acc[5] + xs;
                        acc[6] = acc[6] + ys;
                        acc[7] = acc[7] + ts[s] * xs;
                        acc[8] = acc[8] + ts[s] * ys;
                        acc[9] = acc[9] + dx * xs;
                        acc[10] = acc[10] + dy * ys;
                        acc[11] = acc[11] + dx * ys;
                    }
                    T[s] = T[s] * (1.0f - alpha);
                }
            }
            if (__any_sync(FULL, hit)) {
#pragma unroll
                for (int off = WARP / 2; off > 0; off /= 2) {
#pragma unroll
                    for (int a = 0; a < NACC; ++a) acc[a] += __shfl_xor_sync(FULL, acc[a], off);
                }
            }
            if (lane == 0) {
#pragma unroll
                for (int a = 0; a < NACC; ++a) partial[warp][j][a] = acc[a];
            }
        }
        __syncthreads();  // every warp's partials of the batch are written
        for (int j = p; j < nb; j += npix) {
            float sum[NACC];
#pragma unroll
            for (int a = 0; a < NACC; ++a) sum[a] = partial[0][j][a];
            for (int wi = 1; wi < n_warps; ++wi) {
#pragma unroll
                for (int a = 0; a < NACC; ++a) sum[a] = sum[a] + partial[wi][j][a];
            }
            const float* g = rows + j * P;
            const float ca = g[2], cb = g[3], cc = g[4];
            float4* o = dst + (base + j) * (P / 4);
            o[0] = make_float4(-(ca * sum[5] + cb * sum[6]), -(cc * sum[6] + cb * sum[5]),
                               0.5f * sum[9], sum[11]);
            o[1] = make_float4(0.5f * sum[10], sum[0], sum[1], sum[2]);
            o[2] = make_float4(-sum[4] / fmaxf(g[8], 1e-12f), sum[3], -(ca * sum[7] + cb * sum[8]),
                               -(cc * sum[8] + cb * sum[7]));
            o[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        done = base + nb;
        bool live = false;
#pragma unroll
        for (int s = 0; s < S; ++s) live = live || (T[s] > T_EPS);
        if (!__syncthreads_or(live)) break;
    }
    for (int i = done * (P / 4) + p; i < k * (P / 4); i += npix) {
        dst[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
}

template <int S>
void launch(const float* params, const int* counts, const float* scalars,
            const float* fwd_out, const float* g_out, float* d_params, int n_tiles,
            int k, int tile_w, int npix, int tiles_x, float img_h, cudaStream_t stream) {
    rasterize_bwd_kernel<S><<<n_tiles, npix, 0, stream>>>(
        params, counts, scalars, fwd_out, g_out, d_params, k, tile_w, tiles_x, img_h);
}

}  // namespace

extern "C" int rasterize_bwd_f32(const float* params, const int* counts,
                                 const float* scalars, const float* fwd_out,
                                 const float* g_out, float* d_params, int n_tiles,
                                 int k, int tile_w, int tile_h, int tiles_x,
                                 float img_h, int n_samples, void* stream) {
    if (n_tiles == 0) return 0;
    const int npix = tile_w * tile_h;
    if (npix > MAX_THREADS || npix % WARP) return static_cast<int>(cudaErrorInvalidConfiguration);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SPLAT_CASE(N)                                                                 \
    case N:                                                                           \
        launch<N>(params, counts, scalars, fwd_out, g_out, d_params, n_tiles, k, tile_w, \
                  npix, tiles_x, img_h, s);                                           \
        break;
    switch (n_samples) {
        SPLAT_CASE(1) SPLAT_CASE(2) SPLAT_CASE(3) SPLAT_CASE(4)
        SPLAT_CASE(5) SPLAT_CASE(6) SPLAT_CASE(7) SPLAT_CASE(8)
        SPLAT_CASE(9) SPLAT_CASE(10) SPLAT_CASE(11) SPLAT_CASE(12)
        SPLAT_CASE(13) SPLAT_CASE(14) SPLAT_CASE(15) SPLAT_CASE(16)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef SPLAT_CASE
    return static_cast<int>(cudaGetLastError());
}
