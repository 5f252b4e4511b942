// Row scatter-accumulate: out[d, :] = sum over r with idx[r] == d of g[r, :],
// added in ascending r, for every destination row d < D.
//
// Replaces: scripts_dev/probe_kernel_gather.py, `kernel_scatter` (kernel body
// `scatter_kernel`), which runs `acc[idx[t, j], :] += g[t, j, :]` over a
// sequential grid, so in (t, j) order, into a VMEM-resident accumulator.
//
// Bound on this card: bytes. g (R * P * 4 bytes) and the R indices are read
// once, D * P * 4 bytes are written; one add per element.
//
// Design: blocks run in no order here, and the port uses no float atomics
// (their order changes from run to run). So the wrapper sorts the indices
// with a stable sort and hands the kernel `order` (the source row of each
// sorted position) and `offsets` (the first sorted position of each
// destination row, D + 1 entries). Each destination row belongs to one group
// of lanes (four lanes with a float4 each when P is a multiple of 4, else
// one lane per column) that adds its contributors in sorted order. A stable
// sort keeps equal indices in their original order, so every row sees the
// additions of the sequential (t, j) loop, starting from zero: two launches
// are bitwise equal, and the result is bitwise the sequential loop's.
// Rows with no contributor are written as zeros, so `out` needs no clearing.
#include <cuda_runtime.h>

namespace {

__global__ void row_scatter_vec4(const float4* __restrict__ g,
                                 const int* __restrict__ order,
                                 const int* __restrict__ offsets,
                                 float4* __restrict__ out, long long n, int p4) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long d = i / p4;
    const int c = (int)(i - d * p4);
    const int lo = __ldg(offsets + d), hi = __ldg(offsets + d + 1);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = lo; k < hi; ++k) {
        const float4 v = g[(long long)__ldg(order + k) * p4 + c];
        acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
    out[i] = acc;
}

__global__ void row_scatter_scalar(const float* __restrict__ g,
                                   const int* __restrict__ order,
                                   const int* __restrict__ offsets,
                                   float* __restrict__ out, long long n, int p) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long d = i / p;
    const int c = (int)(i - d * p);
    const int lo = __ldg(offsets + d), hi = __ldg(offsets + d + 1);
    float acc = 0.f;
    for (int k = lo; k < hi; ++k) acc += g[(long long)__ldg(order + k) * p + c];
    out[i] = acc;
}

}  // namespace

extern "C" int row_scatter_f32(const float* g, const int* order, const int* offsets,
                               float* out, long long n_dst_rows, int p, void* stream) {
    if (n_dst_rows == 0 || p == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int threads = 256;
    if (p % 4 == 0) {
        const long long n = n_dst_rows * (p / 4);
        const unsigned blocks = (unsigned)((n + threads - 1) / threads);
        row_scatter_vec4<<<blocks, threads, 0, s>>>(
            reinterpret_cast<const float4*>(g), order, offsets,
            reinterpret_cast<float4*>(out), n, p / 4);
    } else {
        const long long n = n_dst_rows * p;
        const unsigned blocks = (unsigned)((n + threads - 1) / threads);
        row_scatter_scalar<<<blocks, threads, 0, s>>>(g, order, offsets, out, n, p);
    }
    return static_cast<int>(cudaGetLastError());
}
