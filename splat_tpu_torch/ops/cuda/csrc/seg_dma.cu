// Per-tile segment fetch through asynchronous copies into shared memory:
// dense (T, k_pad, P) blocks from the depth-sorted (L, P) stream, the function
// of seg_copy.cu by another route.
//
// Replaces: scripts_dev/probe_seg_dma.py, `pallas_dma` (kernel body
// `dma_kernel`: `tps` tiles per grid step, one async copy per tile from the
// stream into scratch, wait, scratch -> output block) and
// `pallas_dma_aligned` (`dma_kernel_al`: the start floored to `align` rows,
// `k_pad + align` rows copied, the remainder shifted off inside scratch).
//
// Bound on this card: bytes, as seg_copy: each tile's k_pad * P floats read
// and written once, no arithmetic.
//
// Design: one block takes `tps` consecutive tiles. Its threads issue every
// 16-byte piece of all `tps` windows with `cp.async` (the
// `__pipeline_memcpy_async` primitive: global -> shared without passing
// through registers), commit, wait for the whole group, and then write shared
// -> global with coalesced float4 stores. `cp.async` was taken over
// `cp.async.bulk` with an mbarrier because every piece here is a 16-byte
// aligned float4 of a 64-byte row, which the per-thread copy handles without
// a barrier object, a transaction count or a proxy fence; the bulk copy's one
// descriptor per window would save instruction issue, not bytes. tps = 8 at
// k_pad = 256 and P = 16 needs 128 KiB of dynamic shared memory, so the entry
// points opt in above 48 KiB with cudaFuncSetAttribute and return
// cudaErrorInvalidValue when the request exceeds the 227 KiB a block may use.
// The aligned variant never copies a row at or past `n_rows` (the rows a tile
// needs, [start, start + k_pad), always exist; the floor's extra rows may
// not). Output is bitwise `sp[starts[:, None] + arange(k_pad)]`.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxShared = 232448;  // 227 KiB a block may use on sm_90

// align == 0: copy k_pad rows from `start`. align > 0: copy k_pad + align
// rows from floor(start / align) * align and read them back shifted.
__global__ void seg_dma_kernel(const float4* __restrict__ sp, const int* __restrict__ starts,
                               float4* __restrict__ out, int n_tiles, int n_rows, int k_pad,
                               int p4, int tps, int align) {
    extern __shared__ float4 scratch[];
    const int t0 = blockIdx.x * tps;
    const int rows = k_pad + align;               // rows staged per tile
    const int per_tile = rows * p4;               // float4 pieces staged per tile
    const int staged = tps * per_tile;
    for (int i = threadIdx.x; i < staged; i += blockDim.x) {
        const int b = i / per_tile;
        const int off = i - b * per_tile;
        const int t = t0 + b;
        if (t >= n_tiles) break;                  // b only grows with i
        const int start = __ldg(starts + t);
        const int base = align > 0 ? (start / align) * align : start;
        const int row = base + off / p4;
        if (row < n_rows)
            __pipeline_memcpy_async(&scratch[i], sp + (long long)base * p4 + off,
                                    sizeof(float4));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    const int out_tile = k_pad * p4;
    const int n_out = tps * out_tile;
    for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
        const int b = i / out_tile;
        const int off = i - b * out_tile;
        const int t = t0 + b;
        if (t >= n_tiles) break;
        const int start = __ldg(starts + t);
        const int shift = align > 0 ? start - (start / align) * align : 0;
        out[(long long)t * out_tile + off] = scratch[b * per_tile + shift * p4 + off];
    }
}

int launch(const float* sp, const int* starts, float* out, int n_tiles, int n_rows, int k_pad,
           int p, int tps, int align, void* stream) {
    if (n_tiles == 0) return 0;
    if (p % 4 != 0 || tps <= 0 || align < 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long shared = (long long)tps * (k_pad + align) * p * sizeof(float);
    if (shared > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(seg_dma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)shared);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (n_tiles + tps - 1) / tps;
    seg_dma_kernel<<<blocks, 256, (size_t)shared, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(sp), starts, reinterpret_cast<float4*>(out), n_tiles,
        n_rows, k_pad, p / 4, tps, align);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int seg_dma_f32(const float* sp, const int* starts, float* out, int n_tiles,
                           int n_rows, int k_pad, int p, int tps, void* stream) {
    return launch(sp, starts, out, n_tiles, n_rows, k_pad, p, tps, 0, stream);
}

extern "C" int seg_dma_aligned_f32(const float* sp, const int* starts, float* out, int n_tiles,
                                   int n_rows, int k_pad, int p, int tps, int align,
                                   void* stream) {
    if (align <= 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch(sp, starts, out, n_tiles, n_rows, k_pad, p, tps, align, stream);
}
