// Binning: each Gaussian's footprint of tiles, the exact conic cull, and the
// per-tile depth-sorted lists with the slot <-> entry bijection, in kernels
// whose work follows the culled-in entries.
//
// Replaces: no Pallas kernel. The JAX package leaves binning
// (`splat_tpu/ops/tiling.py:build_tile_lists`, `tile_population`) to XLA.
// The port's plain route (`ops/tiling.py`) expands every Gaussian into M
// candidate (Gaussian, tile) entries, culls them, and sorts all N * M of them
// twice (stable by depth, then by tile), dead candidates and dead rows
// included. These kernels build the same lists from the survivors alone:
//
//   count    one thread a Gaussian. A row that is not valid or has no extent
//            exits after reading it. A live row computes its clamped tile
//            rect (XLA's saturating float -> int32 casts and int32 wraparound,
//            as `tiling.gaussian_tile_rects`), then its <= M candidates'
//            conic-vs-rect cull in registers; each survivor takes the next
//            place in its tile by an integer atomic and keeps that rank in
//            entry_slots as ~rank (negative) until the scatter.
//   scan     one block: the tiles' exclusive prefix of the survivors, and the
//            starts and counts of the sorted stream cut at l_cap, as a left
//            searchsorted over the cut stream gives them.
//   scatter  one thread a Gaussian: each survivor writes its 64-bit key, the
//            order-preserving bits of its depth << 32 | its entry index
//            g * M + k, at its tile's prefix + rank, and resets its slot to
//            the dummy.
//   sort     one block a tile: sorts the tile's keys and writes sorted_ids
//            and each landed entry's slot t * K + j. A Gaussian appears in a
//            tile once, so the key order is the plain route's (tile, depth,
//            entry) order, ties included. A segment of up to SORT_CAP keys
//            sorts in shared memory; a longer one sorts in place in device
//            memory through the same network (its SORT_CAP-key chunks in
//            shared memory), and the block counts it in long_tiles.
//
// The cull is the plain route's float32 arithmetic operation for operation
// (`tiling._sigma_min_on_rect`; NaN propagates through minimum / maximum /
// clamp as in PyTorch), with the per-Gaussian budget log(max(op, 1e-12) /
// alpha) + 1e-4 computed by the wrapper with the plain route's own PyTorch
// ops, so no library transcendental can differ. A division by a tile size
// is the product with its float32 reciprocal, as PyTorch's division of a
// CUDA tensor by a Python number is (exact for power-of-two tiles).
//
// Bound on this card: bytes. A row reads ~45 bytes (means, extents, valid,
// motion pad, conic, budget) twice and its depth once if it has a survivor;
// entry_slots (N * M int32) is written once in full; a survivor writes and
// reads its 8-byte key and writes its id and slot; the sorted stream's tail
// past the real entries is filled once. The atomics are integer atomics on
// T + 3 counters; there are no float atomics, and every output is a function
// of the inputs alone (the sort erases the atomics' order).
//
// No launch size depends on the data: count and scatter take ceil(N / 256)
// blocks, the scan one, the sort T. The host never waits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW_BLOCK = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int SORT_THREADS = 512;
constexpr int SORT_CAP = 4096;   // keys a block sorts in shared memory (32 KB)
constexpr int I32_MAX = 2147483647;
constexpr int I32_MIN = -2147483647 - 1;

struct Rows {
    const float* means2d;        // (N, 2)
    const float* extents;        // (N, ext_cols)
    const unsigned char* valid;  // (N,) bool
    const float* pad;            // (N, pad_cols) motion pad, or null
    const float* row0_ptr;       // () strip's first pixel row, or null: row0_val
    int ext_cols, pad_cols, n;
    float row0_val;
};

struct Grid {
    int tiles_x, tiles_y, tiles_y_full;   // tiles of the strip, rows of the full image
    int tile_w, tile_h, span_x, span_y, m;
};

// float -> int32 as XLA converts: saturating, NaN -> 0 (`tiling._f2i`)
__device__ __forceinline__ int f2i(float x) {
    if (x != x) return 0;
    if (x >= 2147483648.0f) return I32_MAX;
    if (x <= -2147483648.0f) return I32_MIN;
    return static_cast<int>(x);
}

// int32 add and subtract with wraparound, as XLA's (`tiling._add_i32`)
__device__ __forceinline__ int add_wrap(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int sub_wrap(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// floor(x / s) as an int32, the division as the card's x * (1 / s)
__device__ __forceinline__ int floor_div(float x, int s) {
    return f2i(floorf(x * (1.0f / static_cast<float>(s))));
}

// torch.maximum / torch.minimum: NaN in, NaN out
__device__ __forceinline__ float maxp(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return a > b ? a : b;
}

__device__ __forceinline__ float minp(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return a < b ? a : b;
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
    return x < lo ? lo : x;
}

struct Rect {
    int x0, y0, w, n_touch;
    bool clipped;
};

// `tiling.gaussian_tile_rects` with max_span (span_x, span_y) for one row,
// then the candidate count w * h of `tiling._expand_tile_entries`.
__device__ Rect tile_rect(const Rows& in, const Grid& gr, float row0, int r0, int g) {
    Rect r{0, 0, 0, 0, false};
    float ex_x = in.extents[g * in.ext_cols];
    float ex_y = in.ext_cols == 2 ? in.extents[g * 2 + 1] : ex_x;
    // keep = valid & (amax(extents) > 0); amax propagates NaN
    bool keep = in.valid[g] != 0 && ex_x == ex_x && ex_y == ex_y && (ex_x > 0.0f || ex_y > 0.0f);
    if (!keep) return r;
    float px = 0.0f, py = 0.0f;
    if (in.pad_cols == 1) {
        px = py = in.pad[g];
    } else if (in.pad_cols == 2) {
        px = in.pad[g * 2];
        py = in.pad[g * 2 + 1];
    }
    float mx = in.means2d[g * 2], my = in.means2d[g * 2 + 1];
    float rx = ex_x + px;
    float ry = ex_y + py;
    float gy = my + row0;
    int x0 = floor_div(mx - rx, gr.tile_w);
    int y0 = floor_div(gy - ry, gr.tile_h);
    int x1 = add_wrap(floor_div(mx + rx, gr.tile_w), 1);
    int y1 = add_wrap(floor_div(gy + ry, gr.tile_h), 1);
    x0 = clampi(x0, 0, gr.tiles_x);
    y0 = clampi(y0, 0, gr.tiles_y_full);
    x1 = clampi(x1, 0, gr.tiles_x);
    y1 = clampi(y1, 0, gr.tiles_y_full);
    int cx = clampi(floor_div(mx, gr.tile_w), 0, gr.tiles_x - 1);
    int cy = clampi(floor_div(gy, gr.tile_h), 0, gr.tiles_y_full - 1);
    bool wide_x = (x1 - x0) > gr.span_x;
    bool wide_y = (y1 - y0) > gr.span_y;
    int nx0 = clampi(cx - gr.span_x / 2, 0, gr.tiles_x);
    int ny0 = clampi(cy - gr.span_y / 2, 0, gr.tiles_y_full);
    if (wide_x) {
        x0 = nx0;
        x1 = min(nx0 + gr.span_x, gr.tiles_x);
    }
    if (wide_y) {
        y0 = ny0;
        y1 = min(ny0 + gr.span_y, gr.tiles_y_full);
    }
    y0 = clampi(sub_wrap(y0, r0), 0, gr.tiles_y);
    y1 = clampi(sub_wrap(y1, r0), 0, gr.tiles_y);
    r.x0 = x0;
    r.y0 = y0;
    r.w = x1 - x0;
    r.n_touch = r.w * (y1 - y0);
    r.clipped = wide_x || wide_y;
    return r;
}

__device__ __forceinline__ float sig(float ca, float cb, float cc, float dx, float dy) {
    return 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
}

// `tiling._sigma_min_on_rect` of one candidate tile, then the cull's test
__device__ __forceinline__ bool survives(int ex, int ey, int sw, int sh, float mx, float my,
                                         float pad_x, float pad_y, float ca, float cb,
                                         float cc, float thr) {
    float lx = static_cast<float>(ex) * static_cast<float>(sw) - mx - pad_x;
    float hx = lx + static_cast<float>(sw) + 2.0f * pad_x;
    float ly = static_cast<float>(ey) * static_cast<float>(sh) - my - pad_y;
    float hy = ly + static_cast<float>(sh) + 2.0f * pad_y;
    float ca_s = clamp_min(ca, 1e-12f);
    float cc_s = clamp_min(cc, 1e-12f);
    float qy = -(cb / cc_s);
    float qx = -(cb / ca_s);
    float v0 = sig(ca, cb, cc, lx, minp(maxp(qy * lx, ly), hy));
    float v1 = sig(ca, cb, cc, hx, minp(maxp(qy * hx, ly), hy));
    float v2 = sig(ca, cb, cc, minp(maxp(qx * ly, lx), hx), ly);
    float v3 = sig(ca, cb, cc, minp(maxp(qx * hy, lx), hx), hy);
    float edge_min = minp(minp(v0, v1), minp(v2, v3));
    bool inside = (lx <= 0.0f) && (0.0f <= hx) && (ly <= 0.0f) && (0.0f <= hy);
    float sig_min = inside ? 0.0f : edge_min;
    return sig_min <= thr;
}

__device__ __forceinline__ void strip_row(const Rows& in, const Grid& gr, float* row0, int* r0) {
    *row0 = in.row0_ptr != nullptr ? *in.row0_ptr : in.row0_val;
    *r0 = f2i(*row0 * (1.0f / static_cast<float>(gr.tile_h)));
}

// conics / thr null: no cull. slots null: count only (tile_population).
__global__ void __launch_bounds__(ROW_BLOCK) count_kernel(
        Rows in, Grid gr, const float* __restrict__ conics, const float* __restrict__ thr,
        int* __restrict__ cnt, int* __restrict__ clipped, int* __restrict__ slots) {
    int g = blockIdx.x * ROW_BLOCK + threadIdx.x;
    bool clip = false;
    if (g < in.n) {
        float row0;
        int r0;
        strip_row(in, gr, &row0, &r0);
        Rect r = tile_rect(in, gr, row0, r0, g);
        clip = r.clipped;
        int n_touch = min(r.n_touch, gr.m);
        if (n_touch > 0) {
            bool cull = conics != nullptr;
            float mx = in.means2d[g * 2], my = in.means2d[g * 2 + 1];
            float pad_x = 0.0f, pad_y = 0.0f, ca = 0.0f, cb = 0.0f, cc = 0.0f, t = 0.0f;
            if (in.pad_cols == 1) {
                pad_x = pad_y = in.pad[g];
            } else if (in.pad_cols == 2) {
                pad_x = in.pad[g * 2];
                pad_y = in.pad[g * 2 + 1];
            }
            if (cull) {
                ca = conics[g * 3];
                cb = conics[g * 3 + 1];
                cc = conics[g * 3 + 2];
                t = thr[g];
            }
            int w_safe = max(r.w, 1);
            for (int k = 0; k < n_touch; ++k) {
                int ex = r.x0 + k % w_safe;
                int ey = r.y0 + k / w_safe;
                if (cull && !survives(ex, ey, gr.tile_w, gr.tile_h, mx, my, pad_x, pad_y, ca,
                                      cb, cc, t))
                    continue;
                int tile = ey * gr.tiles_x + ex;
                if (tile < 0 || tile >= gr.tiles_x * gr.tiles_y) continue;
                int rank = atomicAdd(&cnt[tile], 1);
                if (slots != nullptr) slots[static_cast<long long>(g) * gr.m + k] = ~rank;
            }
        }
    }
    unsigned ballot = __ballot_sync(0xffffffffu, clip);
    if (clipped != nullptr && (threadIdx.x & 31) == 0 && ballot != 0)
        atomicAdd(clipped, __popc(ballot));
}

// prefix (T + 1) of cnt; starts and counts_full of the stream cut at l_cap;
// stats[0] = real entries, stats[1] = real entries past l_cap
__global__ void __launch_bounds__(SCAN_THREADS) scan_kernel(
        const int* __restrict__ cnt, int n_tiles, int l_cap, int* __restrict__ prefix,
        int* __restrict__ starts, int* __restrict__ counts_full, int* __restrict__ stats) {
    __shared__ int warp_sums[SCAN_THREADS / 32];
    int tid = threadIdx.x;
    int per = (n_tiles + SCAN_THREADS - 1) / SCAN_THREADS;
    int lo = min(tid * per, n_tiles), hi = min(lo + per, n_tiles);
    int local = 0;
    for (int t = lo; t < hi; ++t) local += cnt[t];
    // exclusive scan of the threads' sums: warps, then the warps' totals
    int lane = tid & 31, warp = tid >> 5;
    int incl = local;
    for (int d = 1; d < 32; d <<= 1) {
        int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int v = warp_sums[lane];
        int inc = v;
        for (int d = 1; d < 32; d <<= 1) {
            int u = __shfl_up_sync(0xffffffffu, inc, d);
            if (lane >= d) inc += u;
        }
        warp_sums[lane] = inc - v;
    }
    __syncthreads();
    int run = warp_sums[warp] + incl - local;
    for (int t = lo; t < hi; ++t) {
        int next = run + cnt[t];
        prefix[t] = run;
        int s = min(run, l_cap);
        starts[t] = s;
        counts_full[t] = min(next, l_cap) - s;
        run = next;
    }
    if (tid == SCAN_THREADS - 1) {
        prefix[n_tiles] = run;
        stats[0] = run;
        stats[1] = max(run - l_cap, 0);
    }
}

// the order-preserving bits of a depth, as torch.sort orders floats:
// -0.0 equals +0.0, NaN after +inf
__device__ __forceinline__ unsigned depth_bits(float d) {
    if (d != d) return 0xffffffffu;
    unsigned b = __float_as_uint(d);
    if (b == 0x80000000u) b = 0u;
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void __launch_bounds__(ROW_BLOCK) scatter_kernel(
        Rows in, Grid gr, const float* __restrict__ depths, const int* __restrict__ prefix,
        int l_cap, int dummy, int* __restrict__ slots, unsigned long long* __restrict__ keys) {
    int g = blockIdx.x * ROW_BLOCK + threadIdx.x;
    if (g >= in.n) return;
    float row0;
    int r0;
    strip_row(in, gr, &row0, &r0);
    Rect r = tile_rect(in, gr, row0, r0, g);
    int n_touch = min(r.n_touch, gr.m);
    if (n_touch <= 0) return;
    int w_safe = max(r.w, 1);
    unsigned long long hi = static_cast<unsigned long long>(depth_bits(depths[g])) << 32;
    long long e0 = static_cast<long long>(g) * gr.m;
    for (int k = 0; k < n_touch; ++k) {
        int v = slots[e0 + k];
        if (v >= 0) continue;
        slots[e0 + k] = dummy;
        int tile = (r.y0 + k / w_safe) * gr.tiles_x + r.x0 + k % w_safe;
        int base = prefix[tile];
        if (base < l_cap) keys[base + ~v] = hi | static_cast<unsigned>(e0 + k);
    }
}

__device__ __forceinline__ int log2i(int p) { return __ffs(p) - 1; }

__device__ __forceinline__ int pow2_at_least(int n) {
    int p = 1;
    while (p < n) p <<= 1;
    return p;
}

__device__ __forceinline__ void cswap(unsigned long long* s, int i, int l) {
    unsigned long long a = s[i], b = s[l];
    if (a > b) {
        s[i] = b;
        s[l] = a;
    }
}

// One step of the bitonic network in its all-ascending form over a
// power-of-two size p: a flip step pairs i with i ^ (k - 1) in each aligned
// block of k, a half step pairs i with i + j. Places >= n hold virtual
// +infinity: a pair whose upper place is >= n is already in order, so it is
// skipped, and n need not be a power of two.
__device__ __forceinline__ void flip_step(unsigned long long* s, int n, int p, int k) {
    int h = k >> 1, lh = log2i(h);
    for (int q = threadIdx.x; q < (p >> 1); q += blockDim.x) {
        int i = ((q >> lh) << (lh + 1)) + (q & (h - 1));
        int l = i ^ (k - 1);
        if (l < n) cswap(s, i, l);
    }
}

__device__ __forceinline__ void half_step(unsigned long long* s, int n, int p, int j) {
    int lj = log2i(j);
    for (int q = threadIdx.x; q < (p >> 1); q += blockDim.x) {
        int i = ((q >> lj) << (lj + 1)) + (q & (j - 1));
        int l = i + j;
        if (l < n) cswap(s, i, l);
    }
}

// sort s[0, n) ascending, n <= SORT_CAP, in shared memory
__device__ void sort_shared(unsigned long long* s, int n) {
    int p = pow2_at_least(n);
    for (int k = 2; k <= p; k <<= 1) {
        flip_step(s, n, p, k);
        __syncthreads();
        for (int j = k >> 2; j >= 1; j >>= 1) {
            half_step(s, n, p, j);
            __syncthreads();
        }
    }
}

__device__ void load_chunk(unsigned long long* s, const unsigned long long* g, int m) {
    for (int i = threadIdx.x; i < m; i += blockDim.x) s[i] = g[i];
    __syncthreads();
}

__device__ void store_chunk(const unsigned long long* s, unsigned long long* g, int m) {
    for (int i = threadIdx.x; i < m; i += blockDim.x) g[i] = s[i];
    __syncthreads();
}

// sort seg[0, n) ascending in place in device memory, n > SORT_CAP: the same
// network over pow2(n); the steps within a SORT_CAP-aligned chunk run on the
// chunk in shared memory, the others (flips of blocks past SORT_CAP, half
// steps of SORT_CAP or more) in device memory. __syncthreads orders the
// block's device-memory accesses between steps.
__device__ void sort_long(unsigned long long* seg, int n, unsigned long long* s) {
    int p = pow2_at_least(n);
    for (int c0 = 0; c0 < n; c0 += SORT_CAP) {
        int m = min(SORT_CAP, n - c0);
        load_chunk(s, seg + c0, m);
        sort_shared(s, m);
        store_chunk(s, seg + c0, m);
    }
    for (int k = 2 * SORT_CAP; k <= p; k <<= 1) {
        flip_step(seg, n, p, k);
        __syncthreads();
        for (int j = k >> 2; j >= SORT_CAP; j >>= 1) {
            half_step(seg, n, p, j);
            __syncthreads();
        }
        for (int c0 = 0; c0 < n; c0 += SORT_CAP) {
            int m = min(SORT_CAP, n - c0);
            load_chunk(s, seg + c0, m);
            for (int j = SORT_CAP >> 1; j >= 1; j >>= 1) {
                half_step(s, m, SORT_CAP, j);
                __syncthreads();
            }
            store_chunk(s, seg + c0, m);
        }
    }
}

// stats: [0] real entries (from the scan); counters: [0] overflow, [1] long tiles
__global__ void __launch_bounds__(SORT_THREADS) sort_kernel(
        const int* __restrict__ prefix, const int* __restrict__ counts_full,
        const int* __restrict__ counts, const int* __restrict__ stats, int max_per_tile, int m,
        int l_cap, unsigned long long* keys, int* __restrict__ sorted_ids,
        int* __restrict__ slots, int* __restrict__ counters) {
    __shared__ unsigned long long s[SORT_CAP];
    int t = blockIdx.x;
    int base = prefix[t];
    int n = prefix[t + 1] - base;
    int lim = counts_full[t];
    int c = counts[t];
    if (threadIdx.x == 0 && lim != c) atomicAdd(&counters[0], lim - c);
    if (n > 0 && base < l_cap) {
        const unsigned long long* sorted = s;
        if (n <= SORT_CAP) {
            load_chunk(s, keys + base, n);
            sort_shared(s, n);
        } else {
            if (threadIdx.x == 0) atomicAdd(&counters[1], 1);
            sort_long(keys + base, n, s);
            sorted = keys + base;
        }
        int slot0 = t * max_per_tile;
        for (int j = threadIdx.x; j < lim; j += blockDim.x) {
            unsigned e = static_cast<unsigned>(sorted[j]);
            sorted_ids[base + j] = static_cast<int>(e / static_cast<unsigned>(m));
            if (j < c) slots[e] = slot0 + j;
        }
    }
    // the stream past the real entries: a constant valid id, read by nothing
    int real = min(stats[0], l_cap);
    for (long long q = real + static_cast<long long>(t) * SORT_THREADS + threadIdx.x; q < l_cap;
         q += static_cast<long long>(gridDim.x) * SORT_THREADS)
        sorted_ids[q] = 0;
}

Rows make_rows(const float* means2d, const float* extents, int ext_cols,
               const unsigned char* valid, const float* pad, int pad_cols,
               const float* row0_ptr, float row0_val, int n) {
    Rows in;
    in.means2d = means2d;
    in.extents = extents;
    in.valid = valid;
    in.pad = pad;
    in.row0_ptr = row0_ptr;
    in.ext_cols = ext_cols;
    in.pad_cols = pad_cols;
    in.n = n;
    in.row0_val = row0_val;
    return in;
}

Grid make_grid(int tiles_x, int tiles_y, int tiles_y_full, int tile_w, int tile_h, int span_x,
               int span_y) {
    return Grid{tiles_x, tiles_y, tiles_y_full, tile_w, tile_h, span_x, span_y,
                span_x * span_y};
}

}  // namespace

#define BIN_ROW_ARGS                                                                     \
    const float *means2d, const float *extents, int ext_cols, const unsigned char *valid, \
        const float *pad, int pad_cols, const float *row0_ptr, float row0_val, int n,    \
        int tiles_x, int tiles_y, int tiles_y_full, int tile_w, int tile_h, int span_x,  \
        int span_y

// Per-tile counts of the survivors (tile_population): cnt (T,) zeroed by the
// caller, clipped null or a zeroed int.
extern "C" int bin_count_f32(BIN_ROW_ARGS, const float* conics, const float* thr, int* cnt,
                             int* clipped, void* stream) {
    if (n == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    Rows in = make_rows(means2d, extents, ext_cols, valid, pad, pad_cols, row0_ptr, row0_val, n);
    Grid gr = make_grid(tiles_x, tiles_y, tiles_y_full, tile_w, tile_h, span_x, span_y);
    count_kernel<<<(n + ROW_BLOCK - 1) / ROW_BLOCK, ROW_BLOCK, 0, st>>>(in, gr, conics, thr, cnt,
                                                                        clipped, nullptr);
    return static_cast<int>(cudaGetLastError());
}

// count, scan and scatter. ints (zeroed by the caller): cnt (T), clipped,
// overflow, long tiles; then prefix (T + 1), starts (T), counts_full (T),
// stats (2). slots (N * M) filled with dummy by the caller. keys: at least
// min(N * M, l_cap + N) 8-byte places.
extern "C" int bin_front_f32(BIN_ROW_ARGS, const float* conics, const float* thr,
                             const float* depths, int l_cap, int dummy, int* ints, int* slots,
                             unsigned long long* keys, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    Rows in = make_rows(means2d, extents, ext_cols, valid, pad, pad_cols, row0_ptr, row0_val, n);
    Grid gr = make_grid(tiles_x, tiles_y, tiles_y_full, tile_w, tile_h, span_x, span_y);
    int n_tiles = tiles_x * tiles_y;
    int* cnt = ints;
    int* clipped = ints + n_tiles;
    int* prefix = ints + n_tiles + 3;
    int* starts = prefix + n_tiles + 1;
    int* counts_full = starts + n_tiles;
    int* stats = counts_full + n_tiles;
    int blocks = (n + ROW_BLOCK - 1) / ROW_BLOCK;
    if (n > 0)
        count_kernel<<<blocks, ROW_BLOCK, 0, st>>>(in, gr, conics, thr, cnt, clipped, slots);
    scan_kernel<<<1, SCAN_THREADS, 0, st>>>(cnt, n_tiles, l_cap, prefix, starts, counts_full,
                                            stats);
    if (n > 0)
        scatter_kernel<<<blocks, ROW_BLOCK, 0, st>>>(in, gr, depths, prefix, l_cap, dummy, slots,
                                                     keys);
    return static_cast<int>(cudaGetLastError());
}

// The per-tile sort, given the capped counts (T,): writes sorted_ids (l_cap)
// whole, the landed entries' slots, the overflow and the long tiles.
extern "C" int bin_sort(int n_tiles, int max_per_tile, int m, int l_cap, const int* counts,
                        int* ints, int* slots, unsigned long long* keys, int* sorted_ids,
                        void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int* counters = ints + n_tiles + 1;
    int* prefix = ints + n_tiles + 3;
    int* starts = prefix + n_tiles + 1;
    int* counts_full = starts + n_tiles;
    int* stats = counts_full + n_tiles;
    sort_kernel<<<n_tiles, SORT_THREADS, 0, st>>>(prefix, counts_full, counts, stats,
                                                  max_per_tile, m, l_cap, keys, sorted_ids,
                                                  slots, counters);
    return static_cast<int>(cudaGetLastError());
}
