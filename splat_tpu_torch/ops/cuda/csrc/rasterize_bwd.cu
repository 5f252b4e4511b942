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
// The least work a warp-granular design must do counts the pairs and (row,
// pixel) steps only in (row, warp) groups where some pixel composites
// (chip_smoke.py phase 7; the bound is the smaller count). Not counted: the
// 16 shuffles per (Gaussian, warp) that order the per-slot sums. The bytes
// (the rows once, two (T, S, 5, npix) planes in, the (T, K, 16) gradients
// out) are small beside that.
//
// Design: one block per tile, one thread per pixel, S a template parameter so
// the per-sample state (t, T, prefix, A_total and the four cotangents) stays
// in registers. Rows are staged as in rasterize_fwd.cu (raster_common.cuh):
// two shared buffers filled by cp.async, batch b + 1 in flight while batch b
// is processed; a per-row pass forms the tile-local mean, C and the exact
// per-warp cull mask, and a warp whose bit is clear skips the row (it cannot
// composite there, so the recurrence is the unculled one bit for bit). A
// warp whose pixels all have T <= 1e-4 for every sample skips the next
// batches; the block stops after the batch in which every warp has, and
// zeroes the slots it did not reach. The TPU kernel's moment planes and
// pixel-basis matmuls exist to feed the MXU; here each thread sums its twelve
// terms (rgb and depth from w, sum d_sigma, and the d_sigma-weighted moments
// dx, dy, t dx, t dy, dx^2, dy^2, dx dy with dx = dx0 - pvx t) over the
// samples in registers. The per-slot sum over the warp's pixels is a
// transpose-reduce (recursive halving): the twelve sums padded to 16; at
// xor 16 each half of the warp keeps 8 of them and sends the other 8, at
// xor 8 keeps 4 and sends 4, then 2, 1, and a last xor 1 add: 16 shuffles per
// (slot, warp) instead of a 60-shuffle butterfly, and even lane 2i ends with
// sum i, which it writes to its warp's partial. The keep / send choice is a
// select on the lane's bits, not a branch. A warp where no lane composited
// the slot skips the reduction and writes nothing; the warps that wrote set
// their bit in the row's `wrote` word (an integer shared-memory atomicOr),
// and one thread per slot adds the partials of those warps in warp order
// (a fixed order: the sums are deterministic, with no float atomics) and
// combines the moments with the slot's conic and velocity into the 16
// output columns. Built with -fmad=false like the forward kernel, so the
// rerun recurrence matches it exactly. Only the twelve per-pixel
// accumulations are contracted, with explicit __fmaf_rn (they feed no mask,
// and a product rounded once less moves a sum no more than its order does).
// v, d_sigma and the moment offsets keep separate roundings and the IEEE
// division, as the plain version has them: d_sigma is the difference of two
// nearly equal terms where alpha nears its clamp, so a rounding changed there
// moves a slot's gradient far more than the order of its sum does. The
// launch bounds ask for 85 registers a thread at S <= 5: 3 blocks (24
// warps) an SM instead of 2.
#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr int NACC = 12;       // per-slot sums reduced over pixels
constexpr int NRED = 16;       // NACC padded to a power of two for the transpose-reduce
constexpr int PSTRIDE = 13;    // floats per partial (odd: no bank conflicts in the combine)
constexpr float LOG_MAX_ALPHA = -0.0010005003335835335f;  // log(0.999)

// Blocks of 256 threads an SM should hold: 3 (85 registers a thread) up to
// S = 5, the main path's S; 2 above.
constexpr int min_blocks(int S) { return S <= 5 ? 3 : 2; }

// One step of the transpose-reduce: lanes whose bit 2 * HALF is clear keep
// values [0, HALF) and send [HALF, 2 HALF) to their partner, the others the
// reverse; each adds what it receives to what it keeps. HALF shuffles.
template <int HALF>
__device__ __forceinline__ void halve(float (&v)[NRED], int lane) {
    const bool upper = lane & (2 * HALF);
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
        const float keep = upper ? v[i + HALF] : v[i];
        const float send = upper ? v[i] : v[i + HALF];
        v[i] = keep + __shfl_xor_sync(FULL, send, 2 * HALF);
    }
}

// Sum v over the warp's 32 lanes, value by value: on return lane l holds the
// sum of value (l >> 1) & 15 (both lanes of a pair hold it). 8 + 4 + 2 + 1 + 1
// = 16 shuffles.
__device__ __forceinline__ float transpose_reduce(float (&v)[NRED], int lane) {
    halve<8>(v, lane);
    halve<4>(v, lane);
    halve<2>(v, lane);
    halve<1>(v, lane);
    return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

template <int S>
__global__ void __launch_bounds__(MAX_THREADS, min_blocks(S)) rasterize_bwd_kernel(
    const float* __restrict__ params,   // (T, K, P)
    const int* __restrict__ counts,     // (T,)
    const float* __restrict__ scalars,  // [rs, row_offset, eps_0..eps_{S-1}]
    const float* __restrict__ fwd_out,  // (T, S, NOUT, npix)
    const float* __restrict__ g_out,    // (T, S, NOUT, npix)
    float* __restrict__ d_params,       // (T, K, P)
    int k, int tile_w, int tiles_x, float img_h) {
    __shared__ Staging st;
    __shared__ float partial[MAX_WARPS][BATCH][PSTRIDE];
    __shared__ unsigned wrote[BATCH];
    const int t = blockIdx.x;
    const int p = threadIdx.x;
    const int npix = blockDim.x;
    const int lane = p % WARP;
    const int warp = p / WARP;
    if (p == 0) st.tile = make_tile(t, npix, tile_w, tiles_x, img_h, scalars, S);
    const float ty = static_cast<float>((t / tiles_x) * (npix / tile_w));
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
    if (n > 0) stage_rows(st.rows[0], src, min(BATCH, n), p, npix);
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
            stage_rows(st.rows[buf ^ 1], src + (base + BATCH) * P4, min(BATCH, n - base - BATCH),
                       p, npix);
        }
        row_pass(st, buf, nb, p, npix);
        for (int j = p; j < nb; j += npix) wrote[j] = 0u;
        __syncthreads();
        for (int j = 0; warp_live && j < nb; ++j) {
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
            // r, g, b, depth, sum d_sigma, and the d_sigma moments
            // dx, dy, t dx, t dy, dx^2, dy^2, dx dy; padded to NRED
            float acc[NRED];
#pragma unroll
            for (int a = 0; a < NRED; ++a) acc[a] = 0.0f;
            bool hit = false;
#pragma unroll
            for (int s = 0; s < S; ++s) {
                const float sigma = A + ts[s] * (B + ts[s] * C);
                const float lo = lo_hi - sigma;
                if (T[s] > T_EPS && lo >= LOG_THRESH && lo <= lo_hi) {
                    hit = true;
                    const float alpha = fminf(MAX_ALPHA, expf(lo));
                    const float w = T[s] * alpha;
                    const float v = g1.y * dr[s] + g1.z * dg[s] + g1.w * db[s] + g2.y * dd[s];
                    const float contrib = w * v;
                    prefix[s] = prefix[s] + contrib;
                    const float suffix = a_tot[s] - prefix[s];
                    acc[0] = __fmaf_rn(w, dr[s], acc[0]);
                    acc[1] = __fmaf_rn(w, dg[s], acc[1]);
                    acc[2] = __fmaf_rn(w, db[s], acc[2]);
                    acc[3] = __fmaf_rn(w, dd[s], acc[3]);
                    if (lo < LOG_MAX_ALPHA) {
                        const float d_sigma = alpha / (1.0f - alpha) * suffix - contrib;
                        const float dx = dx0 - pvx * ts[s];
                        const float dy = dy0 - pvy * ts[s];
                        const float xs = dx * d_sigma;
                        const float ys = dy * d_sigma;
                        acc[4] = acc[4] + d_sigma;
                        acc[5] = acc[5] + xs;
                        acc[6] = acc[6] + ys;
                        acc[7] = __fmaf_rn(ts[s], xs, acc[7]);
                        acc[8] = __fmaf_rn(ts[s], ys, acc[8]);
                        acc[9] = __fmaf_rn(dx, xs, acc[9]);
                        acc[10] = __fmaf_rn(dy, ys, acc[10]);
                        acc[11] = __fmaf_rn(dx, ys, acc[11]);
                    }
                    T[s] = T[s] * (1.0f - alpha);
                }
            }
            if (__any_sync(FULL, hit)) {   // warp-uniform
                const float sum = transpose_reduce(acc, lane);
                const int idx = lane >> 1;
                if (!(lane & 1) && idx < NACC) partial[warp][j][idx] = sum;
                if (lane == 0) atomicOr(&wrote[j], 1u << warp);
            }
        }
        __syncthreads();  // every warp's partials of the batch are written
        for (int j = p; j < nb; j += npix) {
            float sum[NACC];
#pragma unroll
            for (int a = 0; a < NACC; ++a) sum[a] = 0.0f;
            for (unsigned bits = wrote[j]; bits; bits &= bits - 1u) {   // in warp order
                const int wi = __ffs(bits) - 1;
#pragma unroll
                for (int a = 0; a < NACC; ++a) sum[a] = sum[a] + partial[wi][j][a];
            }
            const float4* g = st.rows[buf] + j * P4;
            const float4 g0 = g[0], g1 = g[1], g2 = g[2];
            const float ca = g0.z, cb = g0.w, cc = g1.x;
            float4* o = dst + (base + j) * P4;
            o[0] = make_float4(-(ca * sum[5] + cb * sum[6]), -(cc * sum[6] + cb * sum[5]),
                               0.5f * sum[9], sum[11]);
            o[1] = make_float4(0.5f * sum[10], sum[0], sum[1], sum[2]);
            o[2] = make_float4(-sum[4] / fmaxf(g2.x, 1e-12f), sum[3], -(ca * sum[7] + cb * sum[8]),
                               -(cc * sum[8] + cb * sum[7]));
            o[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        done = base + nb;
        live = false;
#pragma unroll
        for (int s = 0; s < S; ++s) live = live || (T[s] > T_EPS);
        warp_live = __any_sync(FULL, live);
    }
    for (int i = done * P4 + p; i < k * P4; i += npix) {
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
