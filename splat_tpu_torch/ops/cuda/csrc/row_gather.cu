// Row gather: out[r, :] = table[idx[r], :] for r < R, rows of P floats.
//
// Replaces: scripts_dev/probe_kernel_gather.py, `kernel_gather` (kernel body
// `gather_kernel`), which walks each tile's index list and copies one table
// row per step from a VMEM-resident table. The training path needs the same
// function twice per step: the depth-sorted parameter stream
// `table[sorted_ids]` and, in the backward, the slot gradients at
// `entry_slots`.
//
// Bound on this card: bytes. R * P * 4 bytes are written, the R indices and
// the distinct table rows are read; the table (a few MB) stays in the 50 MB
// L2, so repeated rows cost no device-memory traffic. No arithmetic.
//
// Design: one thread per 16 bytes of output. With P = 16 a row is 64 bytes,
// four lanes per row with one float4 each, so a warp moves eight whole rows
// per step, the stores are fully coalesced and each load fetches whole
// 64-byte rows. Other widths copy float by float. Indices are int32 and are
// read as they are (no widening pass). Output is bitwise `table[idx]`.
// Every idx[r] must lie in [0, table rows): the kernel does not check.
#include <cuda_runtime.h>

namespace {

__global__ void row_gather_vec4(const float4* __restrict__ table,
                                const int* __restrict__ idx,
                                float4* __restrict__ out, long long n, int p4) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long r = i / p4;
    const int c = (int)(i - r * p4);
    out[i] = table[(long long)__ldg(idx + r) * p4 + c];
}

__global__ void row_gather_scalar(const float* __restrict__ table,
                                  const int* __restrict__ idx,
                                  float* __restrict__ out, long long n, int p) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long r = i / p;
    const int c = (int)(i - r * p);
    out[i] = table[(long long)__ldg(idx + r) * p + c];
}

}  // namespace

extern "C" int row_gather_f32(const float* table, const int* idx, float* out,
                              long long n_out_rows, int p, void* stream) {
    if (n_out_rows == 0 || p == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int threads = 256;
    if (p % 4 == 0) {
        const long long n = n_out_rows * (p / 4);
        const unsigned blocks = (unsigned)((n + threads - 1) / threads);
        row_gather_vec4<<<blocks, threads, 0, s>>>(
            reinterpret_cast<const float4*>(table), idx,
            reinterpret_cast<float4*>(out), n, p / 4);
    } else {
        const long long n = n_out_rows * p;
        const unsigned blocks = (unsigned)((n + threads - 1) / threads);
        row_gather_scalar<<<blocks, threads, 0, s>>>(table, idx, out, n, p);
    }
    return static_cast<int>(cudaGetLastError());
}
