// Exclusive cumulative sum along the chunk axis of each (C, NPIX) block of a
// (T, C, NPIX) float32 tensor: out[t, r, x] = sum of in[t, 0..r-1, x].
//
// Replaces: scripts_dev/probe_cumsum.py, `run` (kernel bodies `cumsum_jnp`,
// `cumsum_roll`, `cumsum_mm`), which tries four ways to form this prefix
// along the sublanes of a (128, 1024) block inside one TPU kernel. The
// function is ported, not the four strategies: they answer a question about
// the TPU's vector and matrix units.
//
// Bound on this card: bytes. Every element is read once and written once
// (2 * T * C * NPIX * 4 bytes) for one add each.
//
// Design, two entry points:
//  * chunk_cumsum_seq_f32: one thread per (block, pixel column) walks the C
//    rows in order with the running sum in a register, the recurrence
//    rasterize_fwd.cu uses. Neighbouring threads hold neighbouring pixels, so
//    every load and store is coalesced. The additions are those of a
//    sequential float32 loop.
//  * chunk_cumsum_warp_f32: the card's counterpart of the log-shift variant.
//    A block stages a (C, 32-pixel) slab in shared memory with coalesced
//    loads; each warp then takes pixel columns in turn with the chunk axis
//    laid across its lanes, C / 32 consecutive rows per lane: a serial prefix
//    inside the lane, a 32-lane inclusive scan of the lane totals with
//    __shfl_up_sync (five steps), and the lane's offset added back. The slab
//    goes out with coalesced stores. Sums associate differently from the
//    sequential walk, so it agrees with it to rounding, not bitwise.
#include <cuda_runtime.h>

namespace {

__global__ void cumsum_seq(const float* __restrict__ x, float* __restrict__ out,
                           long long n_cols, int chunk, int npix) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_cols) return;
    const long long t = i / npix;
    const long long base = t * chunk * npix + (i - t * npix);
    float acc = 0.f;
    for (int r = 0; r < chunk; ++r) {
        const float v = x[base + (long long)r * npix];
        out[base + (long long)r * npix] = acc;
        acc += v;
    }
}

constexpr int kSlab = 32;          // pixel columns per block
constexpr int kSlabStride = 33;    // padded row stride in shared memory
constexpr int kWarps = 8;

template <int RPL>                 // rows per lane, chunk == 32 * RPL
__global__ void cumsum_warp(const float* __restrict__ x, float* __restrict__ out, int npix) {
    extern __shared__ float slab[];            // (32 * RPL, kSlabStride)
    constexpr int chunk = 32 * RPL;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int slabs_per_block_row = (npix + kSlab - 1) / kSlab;
    const long long t = blockIdx.x / slabs_per_block_row;
    const int pix = (blockIdx.x % slabs_per_block_row) * kSlab + lane;
    const long long base = t * chunk * npix + pix;
    for (int r = warp; r < chunk; r += kWarps)
        slab[r * kSlabStride + lane] = pix < npix ? x[base + (long long)r * npix] : 0.f;
    __syncthreads();
    for (int col = warp; col < kSlab; col += kWarps) {
        float v[RPL], total = 0.f;
#pragma unroll
        for (int k = 0; k < RPL; ++k) {
            v[k] = slab[(lane * RPL + k) * kSlabStride + col];
            total += v[k];
        }
        float incl = total;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const float up = __shfl_up_sync(0xffffffffu, incl, d);
            if (lane >= d) incl += up;
        }
        float acc = incl - total;              // sum of the lanes below
#pragma unroll
        for (int k = 0; k < RPL; ++k) {
            slab[(lane * RPL + k) * kSlabStride + col] = acc;
            acc += v[k];
        }
    }
    __syncthreads();
    if (pix < npix)
        for (int r = warp; r < chunk; r += kWarps)
            out[base + (long long)r * npix] = slab[r * kSlabStride + lane];
}

template <int RPL>
int launch_warp(const float* x, float* out, long long n_blocks, int npix, cudaStream_t s) {
    const long long grid = n_blocks * ((npix + kSlab - 1) / kSlab);
    const size_t shared = (size_t)32 * RPL * kSlabStride * sizeof(float);
    cumsum_warp<RPL><<<(unsigned)grid, 32 * kWarps, shared, s>>>(x, out, npix);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int chunk_cumsum_seq_f32(const float* x, float* out, long long n_blocks, int chunk,
                                    int npix, void* stream) {
    if (n_blocks == 0 || chunk == 0 || npix == 0) return 0;
    const long long n_cols = n_blocks * npix;
    const int threads = 256;
    cumsum_seq<<<(unsigned)((n_cols + threads - 1) / threads), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(x, out, n_cols, chunk, npix);
    return static_cast<int>(cudaGetLastError());
}

// chunk must be 32, 64, 128 or 256 (1, 2, 4 or 8 rows per lane).
extern "C" int chunk_cumsum_warp_f32(const float* x, float* out, long long n_blocks, int chunk,
                                     int npix, void* stream) {
    if (n_blocks == 0 || npix == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (chunk) {
        case 32: return launch_warp<1>(x, out, n_blocks, npix, s);
        case 64: return launch_warp<2>(x, out, n_blocks, npix, s);
        case 128: return launch_warp<4>(x, out, n_blocks, npix, s);
        case 256: return launch_warp<8>(x, out, n_blocks, npix, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
