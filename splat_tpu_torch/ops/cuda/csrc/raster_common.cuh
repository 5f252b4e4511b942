// Shared by rasterize_fwd.cu and rasterize_bwd.cu: the recurrence's
// constants, the double-buffered asynchronous staging of a tile's rows, and
// the per-row pass that forms the values every pixel shares (the tile-local
// mean, the sigma coefficient C) and the exact per-warp cull mask.
//
// The cull. A warp covers 32 consecutive pixels of the tile (2 rows of 16 in
// a 16x16 or 16x8 tile). Pixel p composites row g at time t only if
//     LOG_THRESH <= lo_hi - sigma(t) <= lo_hi,
//     sigma(t) = 1/2 d^T [[ca, cb], [cb, cc]] d,  d = (px, py) - (mx, my) - pv t,
// so only inside the ellipse sigma <= tau = lo_hi - LOG_THRESH, whose half
// widths are sqrt(2 tau cc / det) in x and sqrt(2 tau ca / det) in y. Swept
// over the tile's least and greatest sample time, it gives a box; a warp
// whose pixel box misses it skips the row. The test is conservative for the
// float32 values the kernels compute (never clears a bit where a pair
// composites), so the outputs are bitwise those of the unculled recurrence:
//   - tau is raised by 2^-13 plus 2^-18 (3.8e-6) of the magnitude of
//     sigma's terms over the tile (the sum of their absolute values: the
//     rounding error of A + t (B + t C), about ten roundings deep, is at most
//     6e-7 of it);
//   - det is lowered by 2^-20 (9.5e-7) of |ca cc| + cb^2 (its own rounding
//     error is under 2.4e-7 of it);
//   - the box grows by 1 px plus 2^-16 (1.5e-5) of its coordinates'
//     magnitude (the rounding of the tile-local mean, the sweep and the half
//     widths);
//   - tau < 0 (lo_hi under the alpha floor) culls the row for every warp:
//     sigma >= 0 then makes lo >= LOG_THRESH impossible;
//   - a non-finite value, ca <= 0 or det <= 0 keeps every bit set.
// The slacks are powers of two, so the plain version's constants are the same
// floats: `warp_hit_mask` in ../rasterize_kernels.py is this computation in
// PyTorch, operation for operation.
#pragma once

#include <cuda_runtime.h>

namespace raster {

constexpr int P = 16;          // floats per parameter row (13 used)
constexpr int P4 = P / 4;      // float4s per row
constexpr int BATCH = 64;      // rows staged in shared memory at a time
constexpr int NOUT = 5;        // r, g, b, depth_acc, T
constexpr int WARP = 32;
constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / WARP;
constexpr float LOG_THRESH = -5.541263545158426f;  // log(1/255)
constexpr float MAX_ALPHA = 0.999f;
constexpr float T_EPS = 1e-4f;
constexpr unsigned FULL = 0xffffffffu;
// the cull's slack (see above)
constexpr float SIGMA_ABS_SLACK = 0x1p-13f;
constexpr float SIGMA_REL_SLACK = 0x1p-18f;
constexpr float DET_REL_SLACK = 0x1p-20f;
constexpr float BOX_MARGIN = 1.0f;
constexpr float BOX_REL_MARGIN = 0x1p-16f;

// What a block knows of its tile.
struct Tile {
    float tx, ty;        // origin in pixels
    float t_lo, t_hi;    // least and greatest sample time of any pixel
    int tile_w, npix, n_warps;
};

// t = eps_s + rs ((py + ty + row_offset) / H - 1/2), formed as the kernels
// form each pixel's: every rounding step is monotone in py and eps_s, so the
// extremes are at the first and last pixel row and the extreme eps.
__device__ __forceinline__ Tile make_tile(int t, int npix, int tile_w, int tiles_x, float img_h,
                                          const float* scalars, int n_samples) {
    Tile tl;
    const int tile_h = npix / tile_w;
    tl.tx = static_cast<float>((t % tiles_x) * tile_w);
    tl.ty = static_cast<float>((t / tiles_x) * tile_h);
    tl.tile_w = tile_w;
    tl.npix = npix;
    tl.n_warps = (npix + WARP - 1) / WARP;
    const float rs = scalars[0];
    const float row_off = scalars[1];
    const float t_first = rs * ((0.5f + tl.ty + row_off) / img_h - 0.5f);
    const float t_last = rs * ((static_cast<float>(tile_h - 1) + 0.5f + tl.ty + row_off) / img_h - 0.5f);
    float e_lo = scalars[2], e_hi = scalars[2];
    for (int s = 1; s < n_samples; ++s) {
        e_lo = fminf(e_lo, scalars[2 + s]);
        e_hi = fmaxf(e_hi, scalars[2 + s]);
    }
    tl.t_lo = e_lo + fminf(t_first, t_last);
    tl.t_hi = e_hi + fmaxf(t_first, t_last);
    return tl;
}

// The lanes of warp `warp` that hold a pixel (all 32 unless the tile's pixel
// count is not a multiple of 32).
__device__ __forceinline__ unsigned warp_lanes(int npix, int warp) {
    const int n = npix - warp * WARP;
    return n >= WARP ? FULL : (1u << n) - 1u;
}

// Bit w set: warp w's pixels may composite the row (see the note above).
__device__ __forceinline__ unsigned warp_mask(float4 r0, float4 r1, float4 r2, float4 r3,
                                              float mx, float my, const Tile& tl) {
    const float ca = r0.z, cb = r0.w, cc = r1.x;
    const float pvx = r2.z, pvy = r2.w, lo_hi = r3.x;
    const unsigned all = (1u << tl.n_warps) - 1u;
    const float chk = ca + cb + cc + pvx + pvy + mx + my + lo_hi + tl.t_lo + tl.t_hi;
    if (!isfinite(chk)) return all;
    if (lo_hi < LOG_THRESH) return 0u;
    const float tau = lo_hi - LOG_THRESH;
    const float det = ca * cc - cb * cb;
    const float det_lo = det - DET_REL_SLACK * (fabsf(ca * cc) + cb * cb);
    if (!(ca > 0.0f && det_lo > 0.0f)) return all;
    const float sx_a = pvx * tl.t_lo, sx_b = pvx * tl.t_hi;
    const float sy_a = pvy * tl.t_lo, sy_b = pvy * tl.t_hi;
    const float sx_abs = fmaxf(fabsf(sx_a), fabsf(sx_b));
    const float sy_abs = fmaxf(fabsf(sy_a), fabsf(sy_b));
    const float tile_h = static_cast<float>(tl.npix / tl.tile_w);
    const float ax = fmaxf(fabsf(0.5f - mx), fabsf(static_cast<float>(tl.tile_w) - 0.5f - mx)) + sx_abs;
    const float ay = fmaxf(fabsf(0.5f - my), fabsf(tile_h - 0.5f - my)) + sy_abs;
    const float mag = 0.5f * (fabsf(ca) * ax * ax + fabsf(cc) * ay * ay) + fabsf(cb) * ax * ay;
    const float tau2 = tau + SIGMA_ABS_SLACK + SIGMA_REL_SLACK * mag;
    const float hx = sqrtf(2.0f * tau2 * cc / det_lo);
    const float hy = sqrtf(2.0f * tau2 * ca / det_lo);
    const float mgx = BOX_MARGIN + BOX_REL_MARGIN * (hx + fabsf(mx) + sx_abs);
    const float mgy = BOX_MARGIN + BOX_REL_MARGIN * (hy + fabsf(my) + sy_abs);
    const float x_lo = mx + fminf(sx_a, sx_b) - hx - mgx;
    const float x_hi = mx + fmaxf(sx_a, sx_b) + hx + mgx;
    const float y_lo = my + fminf(sy_a, sy_b) - hy - mgy;
    const float y_hi = my + fmaxf(sy_a, sy_b) + hy + mgy;
    unsigned mask = 0u;
    for (int w = 0; w < tl.n_warps; ++w) {
        // the pixel centres of warp w: whole rows r0..r1, or part of one row
        const int p0 = w * WARP;
        const int p1 = min(p0 + WARP, tl.npix) - 1;
        const int row0 = p0 / tl.tile_w, row1 = p1 / tl.tile_w;
        const int col0 = row0 == row1 ? p0 % tl.tile_w : 0;
        const int col1 = row0 == row1 ? p1 % tl.tile_w : tl.tile_w - 1;
        const bool miss = x_hi < static_cast<float>(col0) + 0.5f || x_lo > static_cast<float>(col1) + 0.5f
                          || y_hi < static_cast<float>(row0) + 0.5f || y_lo > static_cast<float>(row1) + 0.5f;
        if (!miss) mask |= 1u << w;
    }
    return mask;
}

// Shared memory of a block: two buffers of BATCH staged rows, per row of the
// current batch its shared values and its cull mask, and the tile (kept here
// rather than in every thread's registers: only the per-row pass reads it).
struct Staging {
    float4 rows[2][BATCH * P4];
    float4 rowv[BATCH];         // tile-local mean x, y; C; lo_hi
    unsigned mask[BATCH];
    Tile tile;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Start copying nb rows into dst (16 bytes per thread and step) as one
// cp.async group; every thread commits, with or without copies.
__device__ __forceinline__ void stage_rows(float4* dst, const float4* src, int nb, int p, int nthreads) {
    for (int i = p; i < nb * P4; i += nthreads) cp_async16(dst + i, src + i);
    asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for this thread's copies; a __syncthreads after it makes every
// thread's visible.
__device__ __forceinline__ void stage_wait() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One thread per row of the landed batch: the values every pixel shares
// (formed as each pixel formed them before, so they round alike) and the
// row's cull mask.
__device__ __forceinline__ void row_pass(Staging& st, int buf, int nb, int p, int nthreads) {
    if (p >= nb) return;
    const Tile tl = st.tile;
    for (int j = p; j < nb; j += nthreads) {
        const float4* g = st.rows[buf] + j * P4;
        const float4 r0 = g[0], r1 = g[1], r2 = g[2], r3 = g[3];
        const float mx = r0.x - tl.tx;
        const float my = r0.y - tl.ty;
        const float ca = r0.z, cb = r0.w, cc = r1.x, pvx = r2.z, pvy = r2.w;
        const float C = 0.5f * (ca * pvx * pvx + cc * pvy * pvy) + cb * pvx * pvy;
        st.rowv[j] = make_float4(mx, my, C, r3.x);
        st.mask[j] = warp_mask(r0, r1, r2, r3, mx, my, tl);
    }
}

}  // namespace raster
