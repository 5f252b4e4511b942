// Fused-exposure forward compositing: every tile, every blur sub-frame.
//
// Replaces: splat_tpu/ops/pallas/rasterize_kernels_gmajor.py,
// `rasterize_fwd_gpacked_rowin` (body `_fwd_kernel_g_rowin` ->
// `_fwd_one_tile_g`), the default ("mixed" layout) forward. It computes what
// that kernel computes, not its block structure: per tile, front-to-back
// compositing of <= K depth-sorted Gaussians for S sub-frames, with the
// per-pixel time t = eps_s + rs * ((py + ty + row_offset) / H - 1/2) (global
// scanline over the full height), sigma(t) = A + B t + C t^2 from the mean
// shifted by pix_vel * t, alpha = min(0.999, exp(log_op - sigma)) kept when
// sigma >= 0 and alpha >= 1/255, and a per-pixel stop once T <= 1e-4.
// Outputs per tile and sample: rgb, depth_acc and final T (rows 0-4; the
// TPU kernel's zero pad rows 5-7 are left out).
//
// Bound on this card: operations. Each live (Gaussian, pixel, sample) pair
// costs about 5 FP32 operations for sigma, each pair that composites one expf
// on the special-function units and about 12 more, each live (Gaussian,
// pixel) about 23 for the sigma coefficients; the bytes (the tile's rows
// once, T x S x 5 x npix floats out) are small beside that.
//
// Design: one block per tile, one thread per pixel (256 for 16x16 tiles, 128
// for 16x8). The TPU kernel's log-space matmul prefix becomes the plain
// sequential recurrence each thread runs in registers: S accumulators of
// (r, g, b, depth, T), with S a template parameter (<= 16) so they stay in
// registers. The block stages the tile's rows 64 at a time into shared memory
// (16-byte loads of the 16-float padded rows) and stops as soon as no pixel
// of the tile has T > 1e-4 for any sample (__syncthreads_or), so saturated
// tiles skip their deep tail. A, B and C are formed once per (Gaussian,
// pixel) from tile-local coordinates, as `_stacked_basis` does, and shared
// by all S samples. The library is built with -fmad=false so each product
// and sum rounds as the plain PyTorch version's separate ops do; the masks
// at the alpha floor then agree exactly.
#include <cuda_runtime.h>

namespace {

constexpr int P = 16;          // floats per parameter row (13 used)
constexpr int BATCH = 64;      // rows staged in shared memory at a time
constexpr int NOUT = 5;        // r, g, b, depth_acc, T
constexpr int MAX_THREADS = 256;
constexpr float LOG_THRESH = -5.541263545158426f;  // log(1/255)
constexpr float MAX_ALPHA = 0.999f;
constexpr float T_EPS = 1e-4f;

template <int S>
__global__ void __launch_bounds__(MAX_THREADS) rasterize_fwd_kernel(
    const float* __restrict__ params,   // (T, K, P)
    const int* __restrict__ counts,     // (T,)
    const float* __restrict__ scalars,  // [rs, row_offset, eps_0..eps_{S-1}]
    float* __restrict__ out,            // (T, S, NOUT, npix)
    int k, int tile_w, int tiles_x, float img_h) {
    __shared__ float4 stage[BATCH * P / 4];
    const int t = blockIdx.x;
    const int p = threadIdx.x;
    const int npix = blockDim.x;
    const int tile_h = npix / tile_w;
    const float tx = static_cast<float>((t % tiles_x) * tile_w);
    const float ty = static_cast<float>((t / tiles_x) * tile_h);
    const float px = static_cast<float>(p % tile_w) + 0.5f;
    const float py = static_cast<float>(p / tile_w) + 0.5f;
    const float rs = scalars[0];
    const float row_off = scalars[1];
    const float t_pix = rs * ((py + ty + row_off) / img_h - 0.5f);

    float ts[S], T[S], acc_r[S], acc_g[S], acc_b[S], acc_d[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
        ts[s] = scalars[2 + s] + t_pix;
        T[s] = 1.0f;
        acc_r[s] = acc_g[s] = acc_b[s] = acc_d[s] = 0.0f;
    }

    const int n = min(counts[t], k);
    const float4* src = reinterpret_cast<const float4*>(params + static_cast<long long>(t) * k * P);
    const float* rows = reinterpret_cast<const float*>(stage);
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
#pragma unroll
            for (int s = 0; s < S; ++s) {
                const float sigma = A + ts[s] * (B + ts[s] * C);
                const float lo = lo_hi - sigma;
                if (T[s] > T_EPS && lo >= LOG_THRESH && lo <= lo_hi) {
                    const float alpha = fminf(MAX_ALPHA, expf(lo));
                    const float w = T[s] * alpha;
                    acc_r[s] = acc_r[s] + w * g[5];
                    acc_g[s] = acc_g[s] + w * g[6];
                    acc_b[s] = acc_b[s] + w * g[7];
                    acc_d[s] = acc_d[s] + w * g[9];
                    T[s] = T[s] * (1.0f - alpha);
                }
            }
        }
        bool live = false;
#pragma unroll
        for (int s = 0; s < S; ++s) live = live || (T[s] > T_EPS);
        if (!__syncthreads_or(live)) break;
    }

    float* o = out + static_cast<long long>(t) * S * NOUT * npix + p;
#pragma unroll
    for (int s = 0; s < S; ++s) {
        o[(s * NOUT + 0) * npix] = acc_r[s];
        o[(s * NOUT + 1) * npix] = acc_g[s];
        o[(s * NOUT + 2) * npix] = acc_b[s];
        o[(s * NOUT + 3) * npix] = acc_d[s];
        o[(s * NOUT + 4) * npix] = T[s];
    }
}

template <int S>
void launch(const float* params, const int* counts, const float* scalars, float* out,
            int n_tiles, int k, int tile_w, int npix, int tiles_x, float img_h,
            cudaStream_t stream) {
    rasterize_fwd_kernel<S><<<n_tiles, npix, 0, stream>>>(
        params, counts, scalars, out, k, tile_w, tiles_x, img_h);
}

}  // namespace

extern "C" int rasterize_fwd_max_samples() { return 16; }

extern "C" int rasterize_fwd_f32(const float* params, const int* counts,
                                 const float* scalars, float* out, int n_tiles,
                                 int k, int tile_w, int tile_h, int tiles_x,
                                 float img_h, int n_samples, void* stream) {
    if (n_tiles == 0) return 0;
    const int npix = tile_w * tile_h;
    if (npix > MAX_THREADS) return static_cast<int>(cudaErrorInvalidConfiguration);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SPLAT_CASE(N) \
    case N: launch<N>(params, counts, scalars, out, n_tiles, k, tile_w, npix, tiles_x, img_h, s); break;
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
