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
// once, T x S x 5 x npix floats out) are small beside that. The least work a
// warp-granular design must do counts the pairs and (row, pixel) steps only
// in (row, warp) groups where some pixel composites (chip_smoke.py phase 7
// prints both counts; the bound is the smaller).
//
// Design: one block per tile, one thread per pixel (256 for 16x16 tiles, 128
// for 16x8). The TPU kernel's log-space matmul prefix becomes the plain
// sequential recurrence each thread runs in registers: S accumulators of
// (r, g, b, depth, T), with S a template parameter (<= 16) so they stay in
// registers. The tile's rows are staged 64 at a time into two shared-memory
// buffers by 16-byte cp.async copies: batch b + 1 is in flight while batch b
// is composited, so each batch costs one __syncthreads for the staging and
// one after the per-row pass (raster_common.cuh). That pass, one thread per
// row, forms the tile-local mean and C (the same for every pixel) and a mask
// of the warps whose pixels the row can reach at any sample time of the tile;
// a warp whose bit is clear skips the row with a warp-uniform branch. The
// mask is exact for the float32 values computed here (it never clears a bit
// where a pair composites), so the output is bitwise that of the unculled
// recurrence. A warp whose pixels all have T <= 1e-4 for every sample skips
// the next batches; the block stops when every warp has (__syncthreads_or).
// Each thread reads a row as float4s from shared memory and forms A and B for
// its pixel, shared by all S samples. The library is built with -fmad=false
// so each product and sum that feeds a mask (sigma, lo, alpha, T) rounds as
// the plain PyTorch version's separate ops do, and the masks at the alpha
// floor agree exactly; only the four colour and depth sums are contracted,
// with explicit __fmaf_rn (within the plain comparison's tolerance). The
// tile's own values live in shared memory, not in registers, and the launch
// bounds ask for 64 registers a thread at S <= 5: 4 blocks (32 warps) an SM.
#include "raster_common.cuh"

namespace {

using namespace raster;

// Blocks of 256 threads an SM should hold: 4 (64 registers a thread) up to
// S = 5, the main path's S, where the per-sample state fits; fewer above.
constexpr int min_blocks(int S) { return S <= 5 ? 4 : 2; }

template <int S>
__global__ void __launch_bounds__(MAX_THREADS, min_blocks(S)) rasterize_fwd_kernel(
    const float* __restrict__ params,   // (T, K, P)
    const int* __restrict__ counts,     // (T,)
    const float* __restrict__ scalars,  // [rs, row_offset, eps_0..eps_{S-1}]
    float* __restrict__ out,            // (T, S, NOUT, npix)
    int k, int tile_w, int tiles_x, float img_h) {
    __shared__ Staging st;
    const int t = blockIdx.x;
    const int p = threadIdx.x;
    const int npix = blockDim.x;
    const int warp = p / WARP;
    if (p == 0) st.tile = make_tile(t, npix, tile_w, tiles_x, img_h, scalars, S);
    const float ty = static_cast<float>((t / tiles_x) * (npix / tile_w));
    const float px = static_cast<float>(p % tile_w) + 0.5f;
    const float py = static_cast<float>(p / tile_w) + 0.5f;
    const float rs = scalars[0];
    const float row_off = scalars[1];
    const float t_pix = rs * ((py + ty + row_off) / img_h - 0.5f);
    const unsigned lanes = warp_lanes(npix, warp);

    float ts[S], T[S], acc_r[S], acc_g[S], acc_b[S], acc_d[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
        ts[s] = scalars[2 + s] + t_pix;
        T[s] = 1.0f;
        acc_r[s] = acc_g[s] = acc_b[s] = acc_d[s] = 0.0f;
    }

    const int n = min(counts[t], k);
    const float4* src = reinterpret_cast<const float4*>(params + static_cast<long long>(t) * k * P);
    if (n > 0) stage_rows(st.rows[0], src, min(BATCH, n), p, npix);
    bool live = true;        // this pixel: some sample has T > T_EPS
    bool warp_live = true;   // some pixel of this warp is live
    int buf = 0;
    for (int base = 0; base < n; base += BATCH, buf ^= 1) {
        const int nb = min(BATCH, n - base);
        stage_wait();
        // batch b has landed; batch b - 1's buffer and per-row values are free
        if (!__syncthreads_or(live)) break;
        if (base + BATCH < n) {
            stage_rows(st.rows[buf ^ 1], src + (base + BATCH) * P4, min(BATCH, n - base - BATCH),
                       p, npix);
        }
        row_pass(st, buf, nb, p, npix);
        __syncthreads();
        if (warp_live) {
            for (int j = 0; j < nb; ++j) {
                if (!((st.mask[j] >> warp) & 1u)) continue;   // warp-uniform
                const float4* g = st.rows[buf] + j * P4;
                const float4 g0 = g[0], g1 = g[1], g2 = g[2];
                const float4 rv = st.rowv[j];
                const float ca = g0.z, cb = g0.w, cc = g1.x;
                const float pvx = g2.z, pvy = g2.w, lo_hi = rv.w;
                const float dx0 = px - rv.x;
                const float dy0 = py - rv.y;
                const float A = 0.5f * (ca * dx0 * dx0 + cc * dy0 * dy0) + cb * dx0 * dy0;
                const float B = -(ca * dx0 * pvx + cb * (dx0 * pvy + dy0 * pvx) + cc * dy0 * pvy);
                const float C = rv.z;
#pragma unroll
                for (int s = 0; s < S; ++s) {
                    const float sigma = A + ts[s] * (B + ts[s] * C);
                    const float lo = lo_hi - sigma;
                    if (T[s] > T_EPS && lo >= LOG_THRESH && lo <= lo_hi) {
                        const float alpha = fminf(MAX_ALPHA, expf(lo));
                        const float w = T[s] * alpha;
                        acc_r[s] = __fmaf_rn(w, g1.y, acc_r[s]);
                        acc_g[s] = __fmaf_rn(w, g1.z, acc_g[s]);
                        acc_b[s] = __fmaf_rn(w, g1.w, acc_b[s]);
                        acc_d[s] = __fmaf_rn(w, g2.y, acc_d[s]);
                        T[s] = T[s] * (1.0f - alpha);
                    }
                }
            }
        }
        live = false;
#pragma unroll
        for (int s = 0; s < S; ++s) live = live || (T[s] > T_EPS);
        warp_live = __any_sync(lanes, live);
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
