// Tile fetch: each tile's counted parameter rows straight from the packed
// table, and the backward's sum of each Gaussian's landed slot gradients.
//
// Replaces: no Pallas kernel one for one. It is a fused redesign of two
// ported kernels that the training path ran in a chain, `row_gather`
// (scripts_dev/probe_kernel_gather.py, `kernel_gather`) writing the sorted
// stream table[sorted_ids] plus K zero rows, and `seg_copy`
// (splat_tpu/ops/pallas/seg_copy.py) copying each tile's K-row window out of
// it; and of the backward of the JAX package's `_gather_table`
// (splat_tpu/ops/pallas/__init__.py), which gathers one slot gradient for
// every candidate entry (N * M of them) and sums over M. Both chains move
// bytes that grow with the candidate capacity N * M, while the compositors
// read only min(counts[t], K) rows of a tile and only landed entries carry a
// gradient.
//
// Bound on this card: bytes. Forward: each counted row's id (4 B), its table
// row (64 B) and its block row (64 B), and each tile's start and count.
// Backward: entry_slots (N * M * 4 B), d_table ((N + 1) * 64 B) and each
// landed slot's gradient row (64 B). No arithmetic but the backward's adds.
//
// Design.
//   tile_fetch_fwd_kernel  one block a tile, four lanes a 64-byte row with
//       16 bytes each, so a warp reads eight ids and moves eight whole rows a
//       step. Block rows j < counts[t] (capped at K) get
//       table[sorted_ids[starts[t] + j]], or the zero row where that position
//       is at or past l_cap (a stream capped by max_total_entries; the
//       chain's pad rows were zeros there). Rows counts[t] <= j < K are not
//       written: neither compositor reads them. The grid is T blocks.
//   tile_fetch_bwd_kernel  four lanes a Gaussian row of d_table. Each lane
//       reads the row's M int32 slots (the four lanes the same addresses)
//       and adds the gradient rows of the landed ones (slot < T * K; T * K is
//       the dropped sentinel) in the order m = 0 .. M - 1. Every row is
//       written, the pad row N as zeros, so no fill comes first. No atomics:
//       the sums are the same bits on every run.
// Both grids follow the shapes (T; N), never the data, and nothing waits on
// the host.
#include <cuda_runtime.h>

namespace {

constexpr int P4 = 4;   // float4 lanes in a 16-float row

__global__ void tile_fetch_fwd_kernel(const float4* __restrict__ table,
                                      const int* __restrict__ sorted_ids,
                                      const int* __restrict__ starts,
                                      const int* __restrict__ counts,
                                      float4* __restrict__ blocks, int k, long long l_cap) {
    const int t = blockIdx.x;
    const int n = min(counts[t], k);
    const long long s0 = starts[t];
    float4* dst = blocks + static_cast<long long>(t) * k * P4;
#pragma unroll 4
    for (int i = threadIdx.x; i < n * P4; i += blockDim.x) {
        const long long pos = s0 + (i >> 2);
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (pos < l_cap) v = table[static_cast<long long>(__ldg(sorted_ids + pos)) * P4 + (i & 3)];
        dst[i] = v;
    }
}

__global__ void tile_fetch_bwd_kernel(const float4* __restrict__ g,
                                      const int* __restrict__ entry_slots,
                                      float4* __restrict__ d_table, long long n, int m,
                                      unsigned tk) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= (n + 1) * P4) return;
    const long long r = i >> 2;
    const int c = static_cast<int>(i & 3);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < n) {
        const int* slots = entry_slots + r * m;
#pragma unroll 4
        for (int q = 0; q < m; ++q) {
            const unsigned slot = static_cast<unsigned>(__ldg(slots + q));
            if (slot < tk) {
                const float4 v = g[static_cast<long long>(slot) * P4 + c];
                acc.x += v.x;
                acc.y += v.y;
                acc.z += v.z;
                acc.w += v.w;
            }
        }
    }
    d_table[i] = acc;
}

}  // namespace

extern "C" int tile_fetch_fwd_f32(const float* table, const int* sorted_ids, const int* starts,
                                  const int* counts, float* blocks, int n_tiles, int k,
                                  long long l_cap, void* stream) {
    if (n_tiles == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    tile_fetch_fwd_kernel<<<n_tiles, 256, 0, s>>>(
        reinterpret_cast<const float4*>(table), sorted_ids, starts, counts,
        reinterpret_cast<float4*>(blocks), k, l_cap);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int tile_fetch_bwd_f32(const float* g, const int* entry_slots, float* d_table,
                                  long long n, int m, long long tk, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int threads = 256;
    const long long lanes = (n + 1) * P4;
    const unsigned grid = static_cast<unsigned>((lanes + threads - 1) / threads);
    tile_fetch_bwd_kernel<<<grid, threads, 0, s>>>(
        reinterpret_cast<const float4*>(g), entry_slots, reinterpret_cast<float4*>(d_table), n,
        m, static_cast<unsigned>(tk));
    return static_cast<int>(cudaGetLastError());
}
