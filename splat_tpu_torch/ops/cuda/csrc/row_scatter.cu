// Row scatter-accumulate: out[d, :] = sum over r with idx[r] == d of g[r, :],
// added in ascending r, for every destination row d < D; the plan that orders
// the contributors is made here too.
//
// Replaces: scripts_dev/probe_kernel_gather.py, `kernel_scatter` (kernel body
// `scatter_kernel`), which runs `acc[idx[t, j], :] += g[t, j, :]` over a
// sequential grid, so in (t, j) order, into a VMEM-resident accumulator.
//
// Bound on this card: bytes. g (R * P * 4 bytes) and the R indices are read
// once, D * P * 4 bytes are written; one add per element.
//
// Design: blocks run in no order here, and the port uses no float atomics
// (their order changes from run to run), so the function is two steps.
//
// The plan (`row_scatter_plan_i32`): `order`, the source rows sorted stably
// by destination, and `offsets`, the first sorted position of each
// destination (D + 1 entries); a source outside [0, D) counts as destination
// D, so the dropped ones close `order` in ascending r. It equals
// `scatter_plan_plain`'s stable sort bit for bit, with no sort call, as a
// two-level counting sort whose scattered traffic stays in shared memory:
//   1. chunks of 4096 sources count their destinations' buckets (runs of
//      256 to 16,384 consecutive destinations, at most 1024 buckets, so up
//      to 2^24 - 1 destinations and the dropped) in shared memory into a
//      (bucket, chunk) table;
//   2. a single-pass scan of the table (decoupled look-back over tiles of
//      4096) gives each (bucket, chunk) run its place;
//   3. each chunk groups its sources by bucket in shared memory and writes
//      them out run by run (coalesced): every bucket's sources contiguous;
//   4. a block per bucket counts its sources by destination (writing those
//      destinations' `offsets`), places them at tickets and sorts each
//      destination's sources ascending, which restores the stable order
//      because a destination's source rows are unique. The tickets' order
//      (shared-memory atomics) changes from run to run; the sorted result
//      does not. A bucket of up to 3072 sources with at most 64 a
//      destination is sorted in shared memory by rank counts; any other (a
//      destination holding any share of the sources, up to all) goes
//      through global scratch, and its long segments are sorted by the
//      block through a bitmap of their sources in windows of 65,536: set
//      the bits, prefix-count them, write each set bit's source at its count.
//
// The sum (`row_scatter_f32`, given a plan): a group of P / 4 lanes owns a
// destination, a float4 of its row each, and walks its segment of `order`
// eight contributors at a time: the eight `order` entries are loaded
// together, then the eight rows, all in flight at once, and only then added
// in sorted order from zero: the sequential loop's additions, bit for bit,
// and two launches bitwise equal. A segment is a sequential fold whatever
// its length, so a long one takes its group through its rows eight at a
// time while the other groups go on. Destinations with no contributor are
// written as zeros, so `out` needs no clearing. Rows whose width is not a
// multiple of 4 floats take a lane per column. A sum that staged each
// warp's rows in shared memory by cp.async took 24.7 us at the probe shape on
// the H100 against this kernel's 19.9 (PERF.md §6).
#include "raster_common.cuh"

#include <climits>

namespace {

using raster::allow_dynamic_smem;
using raster::FULL;
using raster::WARP;

constexpr int PLAN_THREADS = 256;
constexpr int SCAN_ITEMS = 16;                          // counts a thread scans
constexpr int SCAN_TILE = PLAN_THREADS * SCAN_ITEMS;    // counts a block scans
constexpr int SHORT_SEG = 64;                           // segments sorted by rank
constexpr int BITMAP_WORDS = 2048;                      // a long segment's window / 32
constexpr int WORDS_PER_THREAD = BITMAP_WORDS / PLAN_THREADS;
constexpr int CHUNK = 4096;                             // sources a block buckets
constexpr int WIDE_THREADS = 1024;                      // the bucketing passes' blocks
constexpr int CHUNK_ITEMS = CHUNK / WIDE_THREADS;
constexpr int MAX_BUCKETS = WIDE_THREADS;               // coarse buckets: one a thread in pass 3
constexpr int MIN_FINE_SHIFT = 8;                       // >= 256 destinations a bucket
constexpr int MAX_FINE_SHIFT = 14;                      // <= 16384: up to 2^24 destinations
constexpr int CAP = 3072;                               // sources a bucket sorts in shared memory
constexpr int TICKET_BITS = 12;                         // CAP < 2^TICKET_BITS
static_assert(CAP % PLAN_THREADS == 0 && CAP < (1 << TICKET_BITS), "a bucket's tickets");
constexpr unsigned long long FLAG_AGGREGATE = 1ull << 32;   // a tile's own total
constexpr unsigned long long FLAG_PREFIX = 2ull << 32;      // the total up to its end


__device__ __forceinline__ int key_of(int v, int n_rows) {
    return static_cast<unsigned>(v) < static_cast<unsigned>(n_rows) ? v : n_rows;
}

// Exclusive prefix of v over the block's threads (in thread order) and, in
// total, the sum of all. Every thread calls it; warp_sums holds 32 ints.
__device__ int block_exclusive_scan(int v, int* warp_sums, int& total) {
    const int lane = threadIdx.x % WARP;
    const int warp = threadIdx.x / WARP;
    const int n_warps = blockDim.x / WARP;
    int x = v;
#pragma unroll
    for (int off = 1; off < WARP; off *= 2) {
        const int y = __shfl_up_sync(FULL, x, off);
        if (lane >= off) x += y;
    }
    if (lane == WARP - 1) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
        int w = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
        for (int off = 1; off < WARP; off *= 2) {
            const int y = __shfl_up_sync(FULL, w, off);
            if (lane >= off) w += y;
        }
        warp_sums[lane] = w;
    }
    __syncthreads();
    const int excl = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    total = warp_sums[n_warps - 1];
    __syncthreads();   // warp_sums may be reused
    return excl;
}

// Shared-memory index of a tile's item j: one pad word every 32, so thread
// t's 16 consecutive items fall in other banks than its neighbours'.
__device__ __forceinline__ int padded(int j) { return j + (j >> 5); }

// offsets[b] = cnt[0] + ... + cnt[b - 1] for the n_bins bins. Single pass: a
// block takes the next tile of SCAN_TILE counts (loaded and stored
// coalesced, scanned 16 to a thread through shared memory), publishes its
// total, and looks back over the tiles before it, 32 at a time, until one
// has published its inclusive prefix.
__global__ void __launch_bounds__(PLAN_THREADS) plan_scan(const int* __restrict__ cnt,
                                                          int* __restrict__ offsets, int n_bins,
                                                          unsigned long long* status,
                                                          unsigned* tile_counter) {
    __shared__ int items[SCAN_TILE + SCAN_TILE / WARP];
    __shared__ int warp_sums[WARP];
    __shared__ int tile_s, prefix_s;
    const int tid = threadIdx.x;
    if (tid == 0) tile_s = static_cast<int>(atomicAdd(tile_counter, 1u));
    __syncthreads();
    const int tile = tile_s;
    const long long base = static_cast<long long>(tile) * SCAN_TILE;
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) {
        const int j = tid + i * PLAN_THREADS;
        items[padded(j)] = base + j < n_bins ? cnt[base + j] : 0;
    }
    __syncthreads();
    int v[SCAN_ITEMS];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) {
        v[i] = items[padded(tid * SCAN_ITEMS + i)];
        sum += v[i];
    }
    int total;
    const int excl = block_exclusive_scan(sum, warp_sums, total);
    if (threadIdx.x < WARP) {   // warp 0 looks back, 32 tiles at a time
        const int lane = threadIdx.x;
        int prefix = 0;
        if (tile == 0) {
            if (lane == 0) atomicExch(status, FLAG_PREFIX | static_cast<unsigned>(total));
        } else {
            if (lane == 0) atomicExch(status + tile, FLAG_AGGREGATE | static_cast<unsigned>(total));
            for (int j0 = tile - 1;; j0 -= WARP) {
                const int j = j0 - lane;      // lane l reads the l-th tile before j0 + 1
                unsigned long long s = FLAG_PREFIX;   // before tile 0: a prefix of 0
                do {
                    if (j >= 0) s = *reinterpret_cast<volatile unsigned long long*>(status + j);
                } while (__any_sync(FULL, !(s & ~0xffffffffull)));   // until all have published
                const unsigned done = __ballot_sync(FULL, (s & ~0xffffffffull) == FLAG_PREFIX);
                // the nearest prefix ends the walk: add the values up to it
                const int last = done ? __ffs(done) - 1 : WARP - 1;
                int v = lane <= last ? static_cast<int>(s & 0xffffffffull) : 0;
#pragma unroll
                for (int off = WARP / 2; off > 0; off /= 2) v += __shfl_xor_sync(FULL, v, off);
                prefix += v;
                if (done) break;
            }
            if (lane == 0) atomicExch(status + tile, FLAG_PREFIX | static_cast<unsigned>(prefix + total));
        }
        if (lane == 0) prefix_s = prefix;
    }
    __syncthreads();
    int run = prefix_s + excl;
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) {
        items[padded(tid * SCAN_ITEMS + i)] = run;
        run += v[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) {
        const int j = tid + i * PLAN_THREADS;
        if (base + j < n_bins) offsets[base + j] = items[padded(j)];
    }
}

// Segment [lo, hi) of tmp sorted ascending into order, by one block: a
// bitmap of its sources over windows of BITMAP_WORDS * 32 source rows from
// the least to the greatest.
__device__ void sort_long_segment(const int* __restrict__ tmp, int* __restrict__ order, int lo,
                                  int hi, unsigned* bitmap, int* warp_sums, int* range) {
    const int tid = threadIdx.x;
    int mn = INT_MAX, mx = -1;
    for (int q = lo + tid; q < hi; q += blockDim.x) {
        const int v = tmp[q];
        mn = min(mn, v);
        mx = max(mx, v);
    }
    for (int off = WARP / 2; off > 0; off /= 2) {
        mn = min(mn, __shfl_xor_sync(FULL, mn, off));
        mx = max(mx, __shfl_xor_sync(FULL, mx, off));
    }
    if (tid == 0) { range[0] = INT_MAX; range[1] = -1; }
    __syncthreads();
    if (tid % WARP == 0) { atomicMin(range, mn); atomicMax(range + 1, mx); }
    __syncthreads();
    const long long first = range[0] & ~31, last = range[1];
    int out = lo;
    for (long long w0 = first; w0 <= last; w0 += BITMAP_WORDS * 32) {
        for (int i = tid; i < BITMAP_WORDS; i += blockDim.x) bitmap[i] = 0u;
        __syncthreads();
        for (int q = lo + tid; q < hi; q += blockDim.x) {
            const long long v = tmp[q] - w0;
            if (v >= 0 && v < BITMAP_WORDS * 32) atomicOr(bitmap + (v >> 5), 1u << (v & 31));
        }
        __syncthreads();
        const int w_first = tid * WORDS_PER_THREAD;
        int c = 0;
#pragma unroll
        for (int i = 0; i < WORDS_PER_THREAD; ++i) c += __popc(bitmap[w_first + i]);
        int total;
        int pos = out + block_exclusive_scan(c, warp_sums, total);
#pragma unroll
        for (int i = 0; i < WORDS_PER_THREAD; ++i) {
            const long long word0 = w0 + 32ll * (w_first + i);
            for (unsigned bits = bitmap[w_first + i]; bits; bits &= bits - 1u)
                order[pos++] = static_cast<int>(word0 + __ffs(bits) - 1);
        }
        out += total;
        __syncthreads();   // the window is read before the next one clears it
    }
}

// Pass 1: table[b * n_chunks + k] = the sources of chunk k (CHUNK of them)
// whose key falls in bucket b (key >> shift), counted in shared memory;
// block 0 also clears the scan's tile states.
__global__ void __launch_bounds__(WIDE_THREADS) plan_bucket_count(
    const int* __restrict__ idx, long long n, int n_rows, int shift, int n_buckets,
    int* __restrict__ table, int n_chunks, unsigned long long* scan_state, int n_state) {
    __shared__ int hist[MAX_BUCKETS];
    const int tid = threadIdx.x;
    if (blockIdx.x == 0) {   // the scan's tile states and counter, for pass 2
        for (int i = tid; i < n_state; i += WIDE_THREADS) scan_state[i] = 0ull;
    }
    const long long base = static_cast<long long>(blockIdx.x) * CHUNK;
    int key[CHUNK_ITEMS];    // all loads in flight before the first atomic
#pragma unroll
    for (int i = 0; i < CHUNK_ITEMS; ++i) {
        const long long r = base + tid + i * WIDE_THREADS;
        key[i] = r < n ? key_of(idx[r], n_rows) : -1;
    }
    for (int b = tid; b < n_buckets; b += WIDE_THREADS) hist[b] = 0;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < CHUNK_ITEMS; ++i) {
        if (key[i] >= 0) atomicAdd(hist + (key[i] >> shift), 1);
    }
    __syncthreads();
    for (int b = tid; b < n_buckets; b += WIDE_THREADS)
        table[static_cast<long long>(b) * n_chunks + blockIdx.x] = hist[b];
}

// Pass 3: chunk k's sources grouped by bucket in shared memory (at a ticket
// in the chunk's run of their bucket), then written out run by run, each at
// its bucket's place for chunk k in `start` (the scan of the table): the
// buckets' sources, chunk after chunk, with their keys.
__global__ void __launch_bounds__(WIDE_THREADS) plan_bucket_place(
    const int* __restrict__ idx, long long n, int n_rows, int shift, int n_buckets,
    const int* __restrict__ table, const int* __restrict__ start, int n_chunks,
    int* __restrict__ out_r, int* __restrict__ out_k) {
    __shared__ int local[MAX_BUCKETS];   // the chunk's runs: start in the chunk, then shift to out
    __shared__ int cursor[MAX_BUCKETS];
    __shared__ int stage_r[CHUNK], stage_k[CHUNK];
    __shared__ int warp_sums[WARP];
    const int tid = threadIdx.x;
    const int k = blockIdx.x;
    // every global load first, all in flight: the chunk's keys, its counts
    // and its runs' places by bucket
    const long long base = static_cast<long long>(k) * CHUNK;
    int key[CHUNK_ITEMS];
#pragma unroll
    for (int i = 0; i < CHUNK_ITEMS; ++i) {
        const long long r = base + tid + i * WIDE_THREADS;
        key[i] = r < n ? key_of(idx[r], n_rows) : -1;
    }
    // thread b: bucket b's count in this chunk, and its run's place in `start`
    const long long cell = static_cast<long long>(tid) * n_chunks + k;
    const int count = tid < n_buckets ? table[cell] : 0;
    const int run_out = tid < n_buckets ? start[cell] : 0;
    int total;
    const int run = block_exclusive_scan(count, warp_sums, total);
    if (tid < n_buckets) {
        local[tid] = run;
        cursor[tid] = 0;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < CHUNK_ITEMS; ++i) {
        if (key[i] >= 0) {
            const int b = key[i] >> shift;
            const int at = local[b] + atomicAdd(cursor + b, 1);
            stage_r[at] = static_cast<int>(base + tid + i * WIDE_THREADS);
            stage_k[at] = key[i];
        }
    }
    __syncthreads();
    if (tid < n_buckets) local[tid] = run_out - run;
    __syncthreads();
    for (int at = tid; at < total; at += WIDE_THREADS) {
        const int key = stage_k[at];
        const int dst = local[key >> shift] + at;
        out_r[dst] = stage_r[at];
        out_k[dst] = key;
    }
}

// Pass 4, a block per bucket: its sources (contiguous after pass 3) counted
// by destination, `offsets` of its destinations, and each destination's
// sources sorted ascending into `order`. A bucket of up to CAP sources whose
// destinations hold up to SHORT_SEG each is sorted in shared memory (placed
// at tickets, then each source written at its rank among its destination's
// sources, a thread per source); another
// goes through tmp: placed there at tickets, short segments sorted by rank
// counts, long ones by the block's bitmap sort.
__global__ void __launch_bounds__(PLAN_THREADS) plan_bucket_sort(
    long long n, int n_rows, int shift, int n_buckets, const int* __restrict__ start,
    int n_chunks, const int* __restrict__ in_r, const int* __restrict__ in_k,
    int* __restrict__ tmp, int* __restrict__ offsets, int* __restrict__ order) {
    extern __shared__ int sm[];
    __shared__ int warp_sums[WARP];
    __shared__ int range[2];
    __shared__ int most;
    const int fine = 1 << shift;
    int* cnt = sm;                 // [fine]
    int* off = cnt + fine;         // [fine]
    int* src = off + fine;         // [CAP]
    int* tag = src + CAP;          // [CAP] destination << TICKET_BITS | ticket
    int* sorted = tag + CAP;       // [CAP]
    const int tid = threadIdx.x;
    const int b = blockIdx.x;
    const int lo_b = start[static_cast<long long>(b) * n_chunks];
    const int size = (b + 1 < n_buckets ? start[static_cast<long long>(b + 1) * n_chunks]
                                        : static_cast<int>(n)) - lo_b;
    const long long d0 = static_cast<long long>(b) << shift;
    const int nf = static_cast<int>(min(static_cast<long long>(fine), n_rows + 1 - d0));
    for (int f = tid; f < nf; f += PLAN_THREADS) cnt[f] = 0;
    if (tid == 0) most = 0;
    __syncthreads();
    const bool fits = size <= CAP;
    if (fits) {
        constexpr int ITEMS = CAP / PLAN_THREADS;
        int r[ITEMS], f[ITEMS];   // all loads in flight before the first atomic
#pragma unroll
        for (int a = 0; a < ITEMS; ++a) {
            const int i = tid + a * PLAN_THREADS;
            r[a] = i < size ? in_r[lo_b + i] : 0;
            f[a] = i < size ? in_k[lo_b + i] - static_cast<int>(d0) : -1;
        }
#pragma unroll
        for (int a = 0; a < ITEMS; ++a) {
            if (f[a] >= 0) {
                const int i = tid + a * PLAN_THREADS;
                src[i] = r[a];
                tag[i] = f[a] << TICKET_BITS | atomicAdd(cnt + f[a], 1);
            }
        }
    } else {
        for (int i = tid; i < size; i += PLAN_THREADS)
            atomicAdd(cnt + (in_k[lo_b + i] - static_cast<int>(d0)), 1);
    }
    __syncthreads();
    // exclusive scan of the counts: a thread takes `per` consecutive ones
    const int per = (nf + PLAN_THREADS - 1) / PLAN_THREADS;
    int sum = 0, top = 0;
    for (int j = 0; j < per; ++j) {
        const int f = tid * per + j;
        if (f < nf) {
            sum += cnt[f];
            top = max(top, cnt[f]);
        }
    }
#pragma unroll
    for (int o = WARP / 2; o > 0; o /= 2) top = max(top, __shfl_xor_sync(FULL, top, o));
    if (tid % WARP == 0) atomicMax(&most, top);
    int total;
    int run = block_exclusive_scan(sum, warp_sums, total);
    for (int j = 0; j < per; ++j) {
        const int f = tid * per + j;
        if (f < nf) {
            off[f] = run;
            offsets[d0 + f] = lo_b + run;
            run += cnt[f];
        }
    }
    __syncthreads();
    if (fits && most <= SHORT_SEG) {
        for (int i = tid; i < size; i += PLAN_THREADS)
            sorted[off[tag[i] >> TICKET_BITS] + (tag[i] & ((1 << TICKET_BITS) - 1))] = src[i];
        __syncthreads();
        // a thread per source: its rank among its destination's sources
        for (int i = tid; i < size; i += PLAN_THREADS) {
            const int f = tag[i] >> TICKET_BITS;
            const int lo = off[f], hi = f + 1 < nf ? off[f + 1] : size;
            const int x = src[i];
            int rank = 0;
            for (int q = lo; q < hi; ++q) rank += sorted[q] < x;
            order[lo_b + lo + rank] = x;
        }
        return;
    }
    for (int f = tid; f < nf; f += PLAN_THREADS) cnt[f] = 0;
    __syncthreads();
    for (int i = tid; i < size; i += PLAN_THREADS) {
        const int f = in_k[lo_b + i] - static_cast<int>(d0);
        tmp[lo_b + off[f] + atomicAdd(cnt + f, 1)] = in_r[lo_b + i];
    }
    __syncthreads();
    for (int f = tid; f < nf; f += PLAN_THREADS) {
        const int lo = lo_b + off[f], hi = lo_b + (f + 1 < nf ? off[f + 1] : size);
        if (hi - lo > SHORT_SEG) continue;
        for (int a = lo; a < hi; ++a) {
            const int x = tmp[a];
            int rank = 0;
            for (int q = lo; q < hi; ++q) rank += tmp[q] < x;
            order[lo + rank] = x;
        }
    }
    for (int f = 0; f < nf; ++f) {   // block-uniform
        const int lo = lo_b + off[f], hi = lo_b + (f + 1 < nf ? off[f + 1] : size);
        if (hi - lo > SHORT_SEG)
            sort_long_segment(tmp, order, lo, hi, reinterpret_cast<unsigned*>(src), warp_sums, range);
    }
}

long long scan_tiles(long long n_items) { return (n_items + SCAN_TILE - 1) / SCAN_TILE; }

// The plan's layout for n sources over n_bins bins: bucket shift, buckets,
// chunks, and the scratch's parts.
struct PlanLayout {
    int shift, n_buckets, n_chunks;
    long long table, tiles;
    long long bytes() const { return (tiles + 1) * 8 + table * 8; }
};

PlanLayout plan_layout(long long n, int n_rows) {
    PlanLayout l;
    const long long n_bins = static_cast<long long>(n_rows) + 1;
    l.shift = MIN_FINE_SHIFT;
    while ((n_bins + (1ll << l.shift) - 1) >> l.shift > MAX_BUCKETS) ++l.shift;
    l.n_buckets = static_cast<int>((n_bins + (1ll << l.shift) - 1) >> l.shift);
    l.n_chunks = static_cast<int>((n + CHUNK - 1) / CHUNK);
    l.table = static_cast<long long>(l.n_buckets) * l.n_chunks;
    l.tiles = scan_tiles(l.table);
    return l;
}

constexpr int BATCH_ROWS = 8;   // contributors a lane loads before it adds

// The sum given a plan: see the note at the top. p4 float4s a row; thread i
// owns float4 i % p4 of destination i / p4.
__global__ void row_scatter_vec4(const float4* __restrict__ g, const int* __restrict__ order,
                                 const int* __restrict__ offsets, float4* __restrict__ out,
                                 long long n, int p4) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long d = i / p4;
    const int c = static_cast<int>(i - d * p4);
    const int lo = __ldg(offsets + d), hi = __ldg(offsets + d + 1);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = lo; k0 < hi; k0 += BATCH_ROWS) {
        int src[BATCH_ROWS];
        float4 v[BATCH_ROWS];
#pragma unroll
        for (int j = 0; j < BATCH_ROWS; ++j) src[j] = k0 + j < hi ? __ldg(order + k0 + j) : -1;
#pragma unroll
        for (int j = 0; j < BATCH_ROWS; ++j)
            v[j] = src[j] >= 0 ? g[static_cast<long long>(src[j]) * p4 + c]
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < BATCH_ROWS; ++j) {
            if (src[j] >= 0) {
                acc.x += v[j].x;
                acc.y += v[j].y;
                acc.z += v[j].z;
                acc.w += v[j].w;
            }
        }
    }
    out[i] = acc;
}

// Any width: one lane per (destination, column) walks its segment.
__global__ void row_scatter_scalar(const float* __restrict__ g, const int* __restrict__ order,
                                   const int* __restrict__ offsets, float* __restrict__ out,
                                   long long n, int p) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long d = i / p;
    const int c = static_cast<int>(i - d * p);
    const int lo = __ldg(offsets + d), hi = __ldg(offsets + d + 1);
    float acc = 0.f;
    for (int k = lo; k < hi; ++k) acc += g[static_cast<long long>(__ldg(order + k)) * p + c];
    out[i] = acc;
}

int launch_plan(const int* idx, long long n, int n_rows, int* order, int* offsets,
                void* scratch, cudaStream_t s) {
    const PlanLayout l = plan_layout(n, n_rows);
    if (l.shift > MAX_FINE_SHIFT) return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return static_cast<int>(cudaMemsetAsync(offsets, 0, (n_rows + 1ll) * 4, s));
    auto* status = static_cast<unsigned long long*>(scratch);
    auto* tile_counter = reinterpret_cast<unsigned*>(status + l.tiles);
    int* table = reinterpret_cast<int*>(status + l.tiles + 1);
    int* start = table + l.table;
    int* by_r = start + l.table;
    int* by_k = by_r + n;
    int* tmp = by_k + n;
    const int sort_smem = (2 * (1 << l.shift) + 3 * CAP) * static_cast<int>(sizeof(int));
    const cudaError_t err = allow_dynamic_smem<plan_bucket_sort>(sort_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    plan_bucket_count<<<l.n_chunks, WIDE_THREADS, 0, s>>>(idx, n, n_rows, l.shift, l.n_buckets,
                                                          table, l.n_chunks, status,
                                                          static_cast<int>(l.tiles + 1));
    plan_scan<<<static_cast<unsigned>(l.tiles), PLAN_THREADS, 0, s>>>(
        table, start, static_cast<int>(l.table), status, tile_counter);
    plan_bucket_place<<<l.n_chunks, WIDE_THREADS, 0, s>>>(idx, n, n_rows, l.shift, l.n_buckets,
                                                          table, start, l.n_chunks, by_r, by_k);
    plan_bucket_sort<<<l.n_buckets, PLAN_THREADS, sort_smem, s>>>(
        n, n_rows, l.shift, l.n_buckets, start, l.n_chunks, by_r, by_k, tmp, offsets, order);
    return static_cast<int>(cudaGetLastError());
}

int launch_sum(const float* g, const int* order, const int* offsets, float* out,
               long long n_dst_rows, int p, cudaStream_t s) {
    if (n_dst_rows == 0 || p == 0) return 0;
    const int threads = 256;
    if (p % 4 == 0) {
        const long long n = n_dst_rows * (p / 4);
        row_scatter_vec4<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0, s>>>(
            reinterpret_cast<const float4*>(g), order, offsets, reinterpret_cast<float4*>(out),
            n, p / 4);
    } else {
        const long long n = n_dst_rows * p;
        row_scatter_scalar<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0, s>>>(
            g, order, offsets, out, n, p);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of scratch the plan needs for n sources and n_rows destinations:
// the scan's tile states and counter, the bucket table and its scan, the
// bucketed sources and keys, and tmp for the buckets sorted outside shared
// memory.
extern "C" long long row_scatter_plan_scratch(long long n, int n_rows) {
    return plan_layout(n, n_rows).bytes() + n * 12;
}

// The plan: order (n) and offsets (n_rows + 1) from the n indices.
extern "C" int row_scatter_plan_i32(const int* idx, long long n, int n_rows, int* order,
                                    int* offsets, void* scratch, void* stream) {
    return launch_plan(idx, n, n_rows, order, offsets, scratch, static_cast<cudaStream_t>(stream));
}

// The sum given a plan.
extern "C" int row_scatter_f32(const float* g, const int* order, const int* offsets,
                               float* out, long long n_dst_rows, int p, void* stream) {
    return launch_sum(g, order, offsets, out, n_dst_rows, p, static_cast<cudaStream_t>(stream));
}

