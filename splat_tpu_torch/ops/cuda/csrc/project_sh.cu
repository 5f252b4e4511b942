// Projection and SH colour of every Gaussian slot at one camera pose: the
// forward, and its analytic backward.
//
// Replaces: no Pallas kernel. The JAX package leaves projection
// (`splat_tpu/ops/projection.py:project_gaussians`) and SH colour
// (`splat_tpu/models/splatfacto.py:sh_eval_switch`) to XLA, which fuses them;
// the port's plain PyTorch runs them as batched 3x3 cuBLAS products and some
// hundreds of one-operation passes over all N slots, forward and backward.
// This pair computes what `models/splatfacto.py:subframe_inputs` computes
// with `project_gaussians(means, exp(scales_log), quats, R_cw, t_cw, ...)`
// and `sh_eval_switch(degree_active, D, normalize(means - pt), coeffs)`,
// R_cw = Rt^T and t_cw = -(R_cw @ pt) from the sub-frame pose (Rt, pt).
//
// Bound on this card: bytes. Per slot the forward reads means, log-scales,
// quaternion, features_dc and features_rest (232 bytes at degree 3) and
// writes the eight projected fields and rgb (61 bytes); the backward reads
// the same inputs and 48 bytes of output gradients and writes 232 bytes of
// parameter gradients. A few hundred FP32 operations a slot forward, about
// a thousand backward, are far under the bytes' time at 67 TFLOP/s.
//
// Design: one thread per Gaussian, 128 Gaussians a block (8192 blocks at
// 2^20 slots), every intermediate in registers. A thread's features_rest row
// is 180 bytes on a 180-byte stride, so a thread-per-row read would waste
// most of every sector: each block stages its 128 rows through shared memory
// with coalesced 16-byte loads (rows padded to an odd stride, so the
// per-thread reads have no bank conflicts), and the backward writes its SH
// gradients back the same way. The highest SH degree D (from features_rest's
// shape) is a template parameter; the active degree is read on the device
// (an int64 scalar) or passed by value, so the host never waits.
//
// The backward is the closed form of the forward's chain rule, recomputing
// the forward's intermediates from the inputs, so nothing of shape (N, 3, 3)
// or (N, 16) is saved between the passes. It keeps autograd's semantics on
// every branch of the plain route: the selects (behind the camera, det <=
// 1e-12, invalid slots), the clamps (frustum, compensation, direction and
// quaternion norms, colour at 0; a clamp passes its gradient at the bound,
// `maximum` / `minimum` split it at a tie), and autograd's own arithmetic
// where a compensation is 0 (g / (2 sqrt(0)): inf or NaN, as the plain route
// gives). Gradients of the Gaussians are written only where asked for. The
// camera's 18 gradient entries (Rt, pt, lin_vel, ang_vel) are summed per
// block in a fixed order (warp shuffles, then the 4 warps in order) and the
// blocks' partial sums by a second kernel, also in a fixed order: no float
// atomics, so the gradients are bitwise repeatable.
//
// The library is built with -fmad=false and IEEE division and square root
// (no fast-math), so every product and sum rounds as a separate float32 op.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
constexpr int WARPS = BLOCK / 32;
// the camera vector: Rt (row-major c2w rotation of the sub-frame pose), pt,
// lin_vel, ang_vel, then fx, fy, cx, cy; the gradient covers the first 18
constexpr int NCAM = 22;
constexpr int NCAM_GRAD = 18;
constexpr int REDUCE_THREADS = 256;

constexpr float CLIP_THRESH = 0.01f;
constexpr float DILATION = 0.3f;

constexpr float SH_C0 = 0.28209479177387814f;
constexpr float SH_C1 = 0.4886025119029199f;
constexpr float SH_C2_0 = 1.0925484305920792f;
constexpr float SH_C2_1 = -1.0925484305920792f;
constexpr float SH_C2_2 = 0.31539156525252005f;
constexpr float SH_C2_3 = -1.0925484305920792f;
constexpr float SH_C2_4 = 0.5462742152960396f;
constexpr float SH_C3_0 = -0.5900435899266435f;
constexpr float SH_C3_1 = 2.890611442640554f;
constexpr float SH_C3_2 = -0.4570457994644658f;
constexpr float SH_C3_3 = 0.3731763325901154f;
constexpr float SH_C3_4 = -0.4570457994644658f;
constexpr float SH_C3_5 = 1.445305721320277f;
constexpr float SH_C3_6 = -0.5900435899266435f;

// torch.clamp / maximum / minimum keep a NaN, as these do
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }
__device__ __forceinline__ float clamp_max(float v, float hi) { return v > hi ? hi : v; }

struct Camera {
    float R[3][3];   // world-to-camera R_cw = Rt^T
    float t[3];      // t_cw = -(R_cw @ pt)
    float pt[3];
    float v[3], w[3];
    float fx, fy, cx, cy, lim_x, lim_y;
};

__device__ __forceinline__ Camera load_camera(const float* __restrict__ cam, int img_w,
                                              int img_h) {
    Camera c;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int j = 0; j < 3; ++j) c.R[k][j] = __ldg(cam + j * 3 + k);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        c.pt[k] = __ldg(cam + 9 + k);
        c.v[k] = __ldg(cam + 12 + k);
        c.w[k] = __ldg(cam + 15 + k);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
        c.t[k] = -(c.R[k][0] * c.pt[0] + c.R[k][1] * c.pt[1] + c.R[k][2] * c.pt[2]);
    c.fx = __ldg(cam + 18);
    c.fy = __ldg(cam + 19);
    c.cx = __ldg(cam + 20);
    c.cy = __ldg(cam + 21);
    // Python's `0.5 * img_w / fx` on a tensor is reciprocal(fx) * (0.5 * img_w)
    c.lim_x = 1.3f * ((1.0f / c.fx) * (0.5f * (float)img_w));
    c.lim_y = 1.3f * ((1.0f / c.fy) * (0.5f * (float)img_h));
    return c;
}

// One Gaussian's forward, with every intermediate the backward reads.
struct Proj {
    float m[3], s[3], q[4];
    float x, y, z, zs;
    bool in_front;
    float qnorm, qden, qn[4];
    float Rq[3][3], M[3][3], P[3][3];
    float c00, c01, c02, c11, c12, c22;
    float vx, ux, wx, vy, uy, wy, tx, ty;
    float inv_z, inv_z2, j00, j02, j11, j12;
    float A0, A1, B0, B1, C0, C1, a, b, c;
    float det_orig, a_d, c_d, det, det_safe, u, comp_raw, inv_det;
    bool det_ok, valid;
    float xd[3];
};

__device__ __forceinline__ void project_one(const Camera& C, const float* __restrict__ means,
                                            const float* __restrict__ scales_log,
                                            const float* __restrict__ quats, long long i,
                                            bool use_vel, Proj& p) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        p.m[k] = __ldg(means + 3 * i + k);
        p.s[k] = expf(__ldg(scales_log + 3 * i + k));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) p.q[k] = __ldg(quats + 4 * i + k);

    p.x = C.R[0][0] * p.m[0] + C.R[0][1] * p.m[1] + C.R[0][2] * p.m[2] + C.t[0];
    p.y = C.R[1][0] * p.m[0] + C.R[1][1] * p.m[1] + C.R[1][2] * p.m[2] + C.t[1];
    p.z = C.R[2][0] * p.m[0] + C.R[2][1] * p.m[1] + C.R[2][2] * p.m[2] + C.t[2];
    p.in_front = p.z > CLIP_THRESH;
    p.zs = p.in_front ? p.z : 1.0f;

    // R(q / max(|q|, 1e-12)), M = R diag(s), Sigma_c = (R_cw M)(R_cw M)^T
    p.qnorm = sqrtf(p.q[0] * p.q[0] + p.q[1] * p.q[1] + p.q[2] * p.q[2] + p.q[3] * p.q[3]);
    p.qden = clamp_min(p.qnorm, 1e-12f);
#pragma unroll
    for (int k = 0; k < 4; ++k) p.qn[k] = p.q[k] / p.qden;
    const float w = p.qn[0], x = p.qn[1], y = p.qn[2], z = p.qn[3];
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, xz = x * z, yz = y * z;
    const float wx = w * x, wy = w * y, wz = w * z;
    p.Rq[0][0] = 1.0f - 2.0f * (yy + zz);
    p.Rq[0][1] = 2.0f * (xy - wz);
    p.Rq[0][2] = 2.0f * (xz + wy);
    p.Rq[1][0] = 2.0f * (xy + wz);
    p.Rq[1][1] = 1.0f - 2.0f * (xx + zz);
    p.Rq[1][2] = 2.0f * (yz - wx);
    p.Rq[2][0] = 2.0f * (xz - wy);
    p.Rq[2][1] = 2.0f * (yz + wx);
    p.Rq[2][2] = 1.0f - 2.0f * (xx + yy);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int j = 0; j < 3; ++j) p.M[r][j] = p.Rq[r][j] * p.s[j];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            p.P[k][j] = C.R[k][0] * p.M[0][j] + C.R[k][1] * p.M[1][j] + C.R[k][2] * p.M[2][j];
    p.c00 = p.P[0][0] * p.P[0][0] + p.P[0][1] * p.P[0][1] + p.P[0][2] * p.P[0][2];
    p.c01 = p.P[0][0] * p.P[1][0] + p.P[0][1] * p.P[1][1] + p.P[0][2] * p.P[1][2];
    p.c02 = p.P[0][0] * p.P[2][0] + p.P[0][1] * p.P[2][1] + p.P[0][2] * p.P[2][2];
    p.c11 = p.P[1][0] * p.P[1][0] + p.P[1][1] * p.P[1][1] + p.P[1][2] * p.P[1][2];
    p.c12 = p.P[1][0] * p.P[2][0] + p.P[1][1] * p.P[2][1] + p.P[1][2] * p.P[2][2];
    p.c22 = p.P[2][0] * p.P[2][0] + p.P[2][1] * p.P[2][1] + p.P[2][2] * p.P[2][2];

    // the EWA Jacobian at the frustum-clamped point
    p.vx = p.x / p.zs;
    p.ux = clamp_min(p.vx, -C.lim_x);
    p.wx = clamp_max(p.ux, C.lim_x);
    p.tx = p.zs * p.wx;
    p.vy = p.y / p.zs;
    p.uy = clamp_min(p.vy, -C.lim_y);
    p.wy = clamp_max(p.uy, C.lim_y);
    p.ty = p.zs * p.wy;
    p.inv_z = 1.0f / p.zs;
    p.inv_z2 = p.inv_z * p.inv_z;
    p.j00 = C.fx * p.inv_z;
    p.j02 = -C.fx * p.tx * p.inv_z2;
    p.j11 = C.fy * p.inv_z;
    p.j12 = -C.fy * p.ty * p.inv_z2;

    p.A0 = p.j00 * p.c00 + p.j02 * p.c02;
    p.A1 = p.j00 * p.c02 + p.j02 * p.c22;
    p.a = p.j00 * p.A0 + p.j02 * p.A1;
    p.B0 = p.j11 * p.c01 + p.j12 * p.c02;
    p.B1 = p.j11 * p.c12 + p.j12 * p.c22;
    p.b = p.j00 * p.B0 + p.j02 * p.B1;
    p.C0 = p.j11 * p.c11 + p.j12 * p.c12;
    p.C1 = p.j11 * p.c12 + p.j12 * p.c22;
    p.c = p.j11 * p.C0 + p.j12 * p.C1;

    p.det_orig = p.a * p.c - p.b * p.b;
    p.a_d = p.a + DILATION;
    p.c_d = p.c + DILATION;
    p.det = p.a_d * p.c_d - p.b * p.b;
    p.det_ok = p.det > 1e-12f;
    p.det_safe = p.det_ok ? p.det : 1.0f;
    p.u = clamp_min(p.det_orig, 0.0f) / p.det_safe;
    p.comp_raw = sqrtf(p.u);
    p.inv_det = 1.0f / p.det_safe;
    p.valid = p.in_front && p.det_ok;

    if (use_vel) {
        // xdot = -(omega x p_cam) - v
        const float cr0 = C.w[1] * p.z - C.w[2] * p.y;
        const float cr1 = C.w[2] * p.x - C.w[0] * p.z;
        const float cr2 = C.w[0] * p.y - C.w[1] * p.x;
        p.xd[0] = -cr0 - C.v[0];
        p.xd[1] = -cr1 - C.v[1];
        p.xd[2] = -cr2 - C.v[2];
    }
}

// Real SH basis up to degree D at a unit direction (eval_sh_basis's order).
template <int D>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* B) {
    B[0] = SH_C0;
    if constexpr (D >= 1) {
        B[1] = -SH_C1 * y;
        B[2] = SH_C1 * z;
        B[3] = -SH_C1 * x;
    }
    if constexpr (D >= 2) {
        const float xx = x * x, yy = y * y, zz = z * z;
        const float xy = x * y, yz = y * z, xz = x * z;
        B[4] = SH_C2_0 * xy;
        B[5] = SH_C2_1 * yz;
        B[6] = SH_C2_2 * (2.0f * zz - xx - yy);
        B[7] = SH_C2_3 * xz;
        B[8] = SH_C2_4 * (xx - yy);
        if constexpr (D >= 3) {
            B[9] = SH_C3_0 * y * (3.0f * xx - yy);
            B[10] = SH_C3_1 * xy * z;
            B[11] = SH_C3_2 * y * (4.0f * zz - xx - yy);
            B[12] = SH_C3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
            B[13] = SH_C3_4 * x * (4.0f * zz - xx - yy);
            B[14] = SH_C3_5 * z * (xx - yy);
            B[15] = SH_C3_6 * x * (xx - 3.0f * yy);
        }
    }
}

// d/d(x, y, z) of sum_k g[k] B_k(x, y, z)
template <int D>
__device__ __forceinline__ void sh_basis_vjp(float x, float y, float z, const float* g,
                                             float& dx, float& dy, float& dz) {
    dx = 0.0f;
    dy = 0.0f;
    dz = 0.0f;
    if constexpr (D >= 1) {
        dy += -SH_C1 * g[1];
        dz += SH_C1 * g[2];
        dx += -SH_C1 * g[3];
    }
    if constexpr (D >= 2) {
        const float xx = x * x, yy = y * y, zz = z * z;
        dx += SH_C2_0 * y * g[4];
        dy += SH_C2_0 * x * g[4];
        dy += SH_C2_1 * z * g[5];
        dz += SH_C2_1 * y * g[5];
        dx += -2.0f * SH_C2_2 * x * g[6];
        dy += -2.0f * SH_C2_2 * y * g[6];
        dz += 4.0f * SH_C2_2 * z * g[6];
        dx += SH_C2_3 * z * g[7];
        dz += SH_C2_3 * x * g[7];
        dx += 2.0f * SH_C2_4 * x * g[8];
        dy += -2.0f * SH_C2_4 * y * g[8];
        if constexpr (D >= 3) {
            const float xy = x * y, yz = y * z, xz = x * z;
            dx += 6.0f * SH_C3_0 * xy * g[9];
            dy += 3.0f * SH_C3_0 * (xx - yy) * g[9];
            dx += SH_C3_1 * yz * g[10];
            dy += SH_C3_1 * xz * g[10];
            dz += SH_C3_1 * xy * g[10];
            dx += -2.0f * SH_C3_2 * xy * g[11];
            dy += SH_C3_2 * (4.0f * zz - xx - 3.0f * yy) * g[11];
            dz += 8.0f * SH_C3_2 * yz * g[11];
            dx += -6.0f * SH_C3_3 * xz * g[12];
            dy += -6.0f * SH_C3_3 * yz * g[12];
            dz += SH_C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * g[12];
            dx += SH_C3_4 * (4.0f * zz - 3.0f * xx - yy) * g[13];
            dy += -2.0f * SH_C3_4 * xy * g[13];
            dz += 8.0f * SH_C3_4 * xz * g[13];
            dx += 2.0f * SH_C3_5 * xz * g[14];
            dy += -2.0f * SH_C3_5 * yz * g[14];
            dz += SH_C3_5 * (xx - yy) * g[14];
            dx += 3.0f * SH_C3_6 * (xx - yy) * g[15];
            dy += -6.0f * SH_C3_6 * xy * g[15];
        }
    }
}

// features_rest rows of RS floats, staged in shared memory on an odd stride SS
template <int RS, int SS>
__device__ __forceinline__ void stage_in(const float* __restrict__ src, long long base,
                                         int rows, float* __restrict__ dst) {
    const float* g = src + base * RS;
    const int total = rows * RS;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
        const int n4 = total / 4;
        const float4* g4 = reinterpret_cast<const float4*>(g);
        for (int v = threadIdx.x; v < n4; v += BLOCK) {
            const float4 q = __ldg(g4 + v);
            const float vals[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int e = 4 * v + k, r = e / RS;
                dst[r * SS + (e - r * RS)] = vals[k];
            }
        }
        done = 4 * n4;
    }
    for (int e = done + threadIdx.x; e < total; e += BLOCK) {
        const int r = e / RS;
        dst[r * SS + (e - r * RS)] = __ldg(g + e);
    }
}

template <int RS, int SS>
__device__ __forceinline__ void stage_out(float* __restrict__ dst, long long base, int rows,
                                          const float* __restrict__ src) {
    float* g = dst + base * RS;
    const int total = rows * RS;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
        const int n4 = total / 4;
        float4* g4 = reinterpret_cast<float4*>(g);
        for (int v = threadIdx.x; v < n4; v += BLOCK) {
            float vals[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int e = 4 * v + k, r = e / RS;
                vals[k] = src[r * SS + (e - r * RS)];
            }
            g4[v] = make_float4(vals[0], vals[1], vals[2], vals[3]);
        }
        done = 4 * n4;
    }
    for (int e = done + threadIdx.x; e < total; e += BLOCK) {
        const int r = e / RS;
        g[e] = src[r * SS + (e - r * RS)];
    }
}

__device__ __forceinline__ int active_bases(const long long* __restrict__ deg_ptr,
                                            int deg_val) {
    const long long d = deg_ptr != nullptr ? *deg_ptr : (long long)deg_val;
    return (int)((d + 1) * (d + 1));
}

template <int D>
struct Shape {
    static constexpr int NB = (D + 1) * (D + 1);
    static constexpr int RS = 3 * (NB - 1);                        // floats per rest row
    static constexpr int SS = RS == 0 ? 1 : (RS % 2 ? RS : RS + 1);  // odd shared stride
};

template <int D>
__global__ void __launch_bounds__(BLOCK) project_sh_fwd_kernel(
    const float* __restrict__ means, const float* __restrict__ scales_log,
    const float* __restrict__ quats, const float* __restrict__ fdc,
    const float* __restrict__ frest, const float* __restrict__ cam,
    const long long* __restrict__ deg_ptr, int deg_val, int n, int img_w, int img_h,
    int use_vel, float* __restrict__ means2d, float* __restrict__ depths,
    float* __restrict__ conics, float* __restrict__ radii, float* __restrict__ comps,
    float* __restrict__ pix_vels, unsigned char* __restrict__ valid_out,
    float* __restrict__ extents, float* __restrict__ colors) {
    using S = Shape<D>;
    __shared__ float rest_s[BLOCK * S::SS];
    const long long base = (long long)blockIdx.x * BLOCK;
    const int rows = (int)min((long long)BLOCK, (long long)n - base);
    if (S::RS > 0) stage_in<S::RS, S::SS>(frest, base, rows, rest_s);
    __syncthreads();
    if ((int)threadIdx.x >= rows) return;
    const long long i = base + threadIdx.x;

    const Camera C = load_camera(cam, img_w, img_h);
    Proj p;
    project_one(C, means, scales_log, quats, i, use_vel != 0, p);

    const float conic0 = p.c_d * p.inv_det;
    const float conic1 = -p.b * p.inv_det;
    const float conic2 = p.a_d * p.inv_det;
    const float mid = 0.5f * (p.a_d + p.c_d);
    const float lam1 = mid + sqrtf(clamp_min(mid * mid - p.det, 0.01f));
    const float radius = ceilf(3.0f * sqrtf(clamp_min(lam1, 0.0f)));
    const float ext0 = ceilf(3.0f * sqrtf(clamp_min(p.a_d, 0.0f)));
    const float ext1 = ceilf(3.0f * sqrtf(clamp_min(p.c_d, 0.0f)));

    means2d[2 * i] = C.fx * p.x * p.inv_z + C.cx;
    means2d[2 * i + 1] = C.fy * p.y * p.inv_z + C.cy;
    depths[i] = p.z;
    conics[3 * i] = conic0;
    conics[3 * i + 1] = conic1;
    conics[3 * i + 2] = conic2;
    radii[i] = p.valid ? radius : 0.0f;
    comps[i] = p.valid ? p.comp_raw : 0.0f;
    valid_out[i] = p.valid ? 1 : 0;
    extents[2 * i] = p.valid ? ext0 : 0.0f;
    extents[2 * i + 1] = p.valid ? ext1 : 0.0f;
    float pvx = 0.0f, pvy = 0.0f;
    if (use_vel && p.valid) {
        pvx = p.j00 * p.xd[0] + p.j02 * p.xd[2];
        pvy = p.j11 * p.xd[1] + p.j12 * p.xd[2];
    }
    pix_vels[2 * i] = pvx;
    pix_vels[2 * i + 1] = pvy;

    // colour: the basis at normalize(means - pt), bands above the active
    // degree masked, clip(SH + 0.5, min=0)
    const float d0 = p.m[0] - C.pt[0], d1 = p.m[1] - C.pt[1], d2 = p.m[2] - C.pt[2];
    const float dn = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
    const float den = clamp_min(dn, 1e-9f);
    float B[S::NB];
    sh_basis<D>(d0 / den, d1 / den, d2 / den, B);
    const int n_active = active_bases(deg_ptr, deg_val);
    const float* rest = rest_s + threadIdx.x * S::SS;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        float acc = B[0] * __ldg(fdc + 3 * i + ch);
#pragma unroll
        for (int k = 1; k < S::NB; ++k) {
            const float bm = B[k] * (k < n_active ? 1.0f : 0.0f);
            acc += bm * rest[3 * (k - 1) + ch];
        }
        colors[3 * i + ch] = clamp_min(acc + 0.5f, 0.0f);
    }
}

template <int D>
__global__ void __launch_bounds__(BLOCK) project_sh_bwd_kernel(
    const float* __restrict__ means, const float* __restrict__ scales_log,
    const float* __restrict__ quats, const float* __restrict__ fdc,
    const float* __restrict__ frest, const float* __restrict__ cam,
    const long long* __restrict__ deg_ptr, int deg_val, int n, int img_w, int img_h,
    int use_vel, const float* __restrict__ g_means2d, const float* __restrict__ g_depths,
    const float* __restrict__ g_conics, const float* __restrict__ g_comps,
    const float* __restrict__ g_pix_vels, const float* __restrict__ g_colors,
    float* __restrict__ d_means, float* __restrict__ d_scales_log,
    float* __restrict__ d_quats, float* __restrict__ d_fdc, float* __restrict__ d_frest,
    float* __restrict__ partial) {
    using S = Shape<D>;
    __shared__ float rest_s[BLOCK * S::SS];
    __shared__ float red_s[WARPS][NCAM_GRAD];
    const long long base = (long long)blockIdx.x * BLOCK;
    const int rows = (int)min((long long)BLOCK, (long long)n - base);
    if (S::RS > 0) stage_in<S::RS, S::SS>(frest, base, rows, rest_s);
    __syncthreads();
    const long long i = base + threadIdx.x;
    // the camera's gradient contributions: Rt (9, row-major), pt, lin_vel, ang_vel
    float gc[NCAM_GRAD];
#pragma unroll
    for (int k = 0; k < NCAM_GRAD; ++k) gc[k] = 0.0f;

    if ((int)threadIdx.x < rows) {
        const Camera C = load_camera(cam, img_w, img_h);
        Proj p;
        project_one(C, means, scales_log, quats, i, use_vel != 0, p);

        // ---- colour ----
        const float d[3] = {p.m[0] - C.pt[0], p.m[1] - C.pt[1], p.m[2] - C.pt[2]};
        const float dn = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
        const float den = clamp_min(dn, 1e-9f);
        const float dir[3] = {d[0] / den, d[1] / den, d[2] / den};
        float B[S::NB];
        sh_basis<D>(dir[0], dir[1], dir[2], B);
        const int n_active = active_bases(deg_ptr, deg_val);
        float* rest = rest_s + threadIdx.x * S::SS;
        float dc[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) dc[ch] = __ldg(fdc + 3 * i + ch);
        float go[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            float acc = B[0] * dc[ch];
#pragma unroll
            for (int k = 1; k < S::NB; ++k) {
                const float bm = B[k] * (k < n_active ? 1.0f : 0.0f);
                acc += bm * rest[3 * (k - 1) + ch];
            }
            go[ch] = (acc + 0.5f >= 0.0f) ? __ldg(g_colors + 3 * i + ch) : 0.0f;
        }
        // d basis (masked), then the coefficients' gradients in place of
        // the coefficients
        float dB[S::NB];
        dB[0] = go[0] * dc[0] + go[1] * dc[1] + go[2] * dc[2];
#pragma unroll
        for (int k = 1; k < S::NB; ++k) {
            const float mk = k < n_active ? 1.0f : 0.0f;
            const float* r = rest + 3 * (k - 1);
            dB[k] = (go[0] * r[0] + go[1] * r[1] + go[2] * r[2]) * mk;
        }
        if (d_fdc != nullptr) {
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) d_fdc[3 * i + ch] = B[0] * go[ch];
        }
        if (d_frest != nullptr) {
#pragma unroll
            for (int k = 1; k < S::NB; ++k) {
                const float bm = B[k] * (k < n_active ? 1.0f : 0.0f);
#pragma unroll
                for (int ch = 0; ch < 3; ++ch) rest[3 * (k - 1) + ch] = bm * go[ch];
            }
        }
        float ddir[3];
        sh_basis_vjp<D>(dir[0], dir[1], dir[2], dB, ddir[0], ddir[1], ddir[2]);
        // dir = d / max(|d|, 1e-9)
        float dd[3];
        float d_den = 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            dd[k] = ddir[k] / den;
            d_den += -ddir[k] * (dir[k] / den);
        }
        const float d_dn = dn >= 1e-9f ? d_den : 0.0f;
        const float d_scale = dn == 0.0f ? 0.0f : d_dn / dn;
#pragma unroll
        for (int k = 0; k < 3; ++k) dd[k] += d[k] * d_scale;

        // ---- projected outputs ----
        const float gm0 = __ldg(g_means2d + 2 * i), gm1 = __ldg(g_means2d + 2 * i + 1);
        const float gca = __ldg(g_conics + 3 * i), gcb = __ldg(g_conics + 3 * i + 1),
                    gcc = __ldg(g_conics + 3 * i + 2);
        const float gcomp = p.valid ? __ldg(g_comps + i) : 0.0f;
        float dp[3] = {0.0f, 0.0f, 0.0f};
        dp[2] = __ldg(g_depths + i);
        float d_j00 = 0.0f, d_j02 = 0.0f, d_j11 = 0.0f, d_j12 = 0.0f, d_inv_z = 0.0f;
        float dv[3] = {0.0f, 0.0f, 0.0f}, dw[3] = {0.0f, 0.0f, 0.0f};
        if (use_vel) {
            const float gpx = p.valid ? __ldg(g_pix_vels + 2 * i) : 0.0f;
            const float gpy = p.valid ? __ldg(g_pix_vels + 2 * i + 1) : 0.0f;
            d_j00 += gpx * p.xd[0];
            d_j02 += gpx * p.xd[2];
            d_j11 += gpy * p.xd[1];
            d_j12 += gpy * p.xd[2];
            const float dxd[3] = {gpx * p.j00, gpy * p.j11, gpx * p.j02 + gpy * p.j12};
            // xdot = -(omega x p_cam) - v
#pragma unroll
            for (int k = 0; k < 3; ++k) dv[k] = -dxd[k];
            dw[0] = dxd[1] * p.z - dxd[2] * p.y;
            dw[1] = dxd[2] * p.x - dxd[0] * p.z;
            dw[2] = dxd[0] * p.y - dxd[1] * p.x;
            dp[0] += C.w[1] * dxd[2] - C.w[2] * dxd[1];
            dp[1] += C.w[2] * dxd[0] - C.w[0] * dxd[2];
            dp[2] += C.w[0] * dxd[1] - C.w[1] * dxd[0];
        }
        // means2d = fx * x * inv_z + cx
        dp[0] += gm0 * p.inv_z * C.fx;
        dp[1] += gm1 * p.inv_z * C.fy;
        d_inv_z += gm0 * (C.fx * p.x) + gm1 * (C.fy * p.y);

        // compensation sqrt(max(det_orig, 0) / det_safe), with autograd's
        // arithmetic (inf or NaN where it is 0)
        const float du = gcomp / (2.0f * p.comp_raw);
        const float d_cl = du / p.det_safe;
        float d_det_safe = -du * (p.u / p.det_safe);
        const float d_det_orig = p.det_orig >= 0.0f ? d_cl : 0.0f;
        // conics (c_d, -b, a_d) / det_safe
        const float d_inv_det = gca * p.c_d + gcb * (-p.b) + gcc * p.a_d;
        float d_c_d = gca * p.inv_det;
        float d_b = -(gcb * p.inv_det);
        float d_a_d = gcc * p.inv_det;
        d_det_safe += d_inv_det * -(p.inv_det * p.inv_det);
        const float d_det = p.det_ok ? d_det_safe : 0.0f;
        d_a_d += d_det * p.c_d;
        d_c_d += d_det * p.a_d;
        d_b += -2.0f * p.b * d_det;
        const float da = d_det_orig * p.c + d_a_d;
        const float dcc = d_det_orig * p.a + d_c_d;
        d_b += -2.0f * p.b * d_det_orig;
        const float db = d_b;

        // a, b, c = J Sigma_c J^T
        float dc00, dc01, dc02, dc11, dc12, dc22;
        {
            const float dA0 = da * p.j00, dA1 = da * p.j02;
            const float dB0 = db * p.j00, dB1 = db * p.j02;
            const float dC0 = dcc * p.j11, dC1 = dcc * p.j12;
            d_j00 += da * p.A0 + dA0 * p.c00 + dA1 * p.c02 + db * p.B0;
            d_j02 += da * p.A1 + dA0 * p.c02 + dA1 * p.c22 + db * p.B1;
            d_j11 += dB0 * p.c01 + dB1 * p.c12 + dcc * p.C0 + dC0 * p.c11 + dC1 * p.c12;
            d_j12 += dB0 * p.c02 + dB1 * p.c22 + dcc * p.C1 + dC0 * p.c12 + dC1 * p.c22;
            dc00 = dA0 * p.j00;
            dc01 = dB0 * p.j11;
            dc02 = dA0 * p.j02 + dA1 * p.j00 + dB0 * p.j12;
            dc11 = dC0 * p.j11;
            dc12 = dB1 * p.j11 + dC0 * p.j12 + dC1 * p.j11;
            dc22 = dA1 * p.j02 + dB1 * p.j12 + dC1 * p.j12;
        }
        // J from zs, tx, ty
        d_inv_z += d_j00 * C.fx + d_j11 * C.fy;
        const float d_tx = d_j02 * p.inv_z2 * (-C.fx);
        const float d_ty = d_j12 * p.inv_z2 * (-C.fy);
        const float d_inv_z2 = d_j02 * (-C.fx * p.tx) + d_j12 * (-C.fy * p.ty);
        d_inv_z += 2.0f * p.inv_z * d_inv_z2;
        float d_zs = -d_inv_z * (p.inv_z * p.inv_z);
        // t = zs * min(max(v, -lim), lim), v = x / zs; ties split the gradient
        {
            d_zs += d_tx * p.wx + d_ty * p.wy;
            const float fx_max = p.vx == -C.lim_x ? 0.5f : (p.vx < -C.lim_x ? 0.0f : 1.0f);
            const float fx_min = p.ux == C.lim_x ? 0.5f : (p.ux > C.lim_x ? 0.0f : 1.0f);
            const float fy_max = p.vy == -C.lim_y ? 0.5f : (p.vy < -C.lim_y ? 0.0f : 1.0f);
            const float fy_min = p.uy == C.lim_y ? 0.5f : (p.uy > C.lim_y ? 0.0f : 1.0f);
            const float d_vx = d_tx * p.zs * fx_min * fx_max;
            const float d_vy = d_ty * p.zs * fy_min * fy_max;
            dp[0] += d_vx / p.zs;
            dp[1] += d_vy / p.zs;
            d_zs += -d_vx * (p.vx / p.zs) - d_vy * (p.vy / p.zs);
        }
        if (p.in_front) dp[2] += d_zs;

        // Sigma_c = P P^T (upper triangle read): dP = (G + G^T) P
        const float Gs[3][3] = {{2.0f * dc00, dc01, dc02},
                                {dc01, 2.0f * dc11, dc12},
                                {dc02, dc12, 2.0f * dc22}};
        float dP[3][3];
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int j = 0; j < 3; ++j)
                dP[k][j] = Gs[k][0] * p.P[0][j] + Gs[k][1] * p.P[1][j] + Gs[k][2] * p.P[2][j];
        // P = R_cw M: dM = R_cw^T dP, dR_cw += dP M^T
        float dM[3][3];
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
            for (int j = 0; j < 3; ++j)
                dM[r][j] = C.R[0][r] * dP[0][j] + C.R[1][r] * dP[1][j] + C.R[2][r] * dP[2][j];

        // p_cam = R_cw m + t_cw, t_cw = -R_cw pt
        float dm[3];
#pragma unroll
        for (int j = 0; j < 3; ++j)
            dm[j] = C.R[0][j] * dp[0] + C.R[1][j] * dp[1] + C.R[2][j] * dp[2] + dd[j];

        if (partial != nullptr) {
            // d Rt[j][k] = d R_cw[k][j] = dp_k (m_j - pt_j) + (dP M^T)_kj
#pragma unroll
            for (int k = 0; k < 3; ++k)
#pragma unroll
                for (int j = 0; j < 3; ++j)
                    gc[j * 3 + k] = dp[k] * (p.m[j] - C.pt[j])
                        + (dP[k][0] * p.M[j][0] + dP[k][1] * p.M[j][1] + dP[k][2] * p.M[j][2]);
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                gc[9 + j] = -(C.R[0][j] * dp[0] + C.R[1][j] * dp[1] + C.R[2][j] * dp[2]) - dd[j];
                gc[12 + j] = dv[j];
                gc[15 + j] = dw[j];
            }
        }
        if (d_means != nullptr) {
#pragma unroll
            for (int j = 0; j < 3; ++j) d_means[3 * i + j] = dm[j];
        }
        if (d_scales_log != nullptr || d_quats != nullptr) {
            // M = Rq diag(s)
            float dRq[3][3];
#pragma unroll
            for (int r = 0; r < 3; ++r)
#pragma unroll
                for (int j = 0; j < 3; ++j) dRq[r][j] = dM[r][j] * p.s[j];
            if (d_scales_log != nullptr) {
#pragma unroll
                for (int j = 0; j < 3; ++j) {
                    const float ds = dM[0][j] * p.Rq[0][j] + dM[1][j] * p.Rq[1][j]
                        + dM[2][j] * p.Rq[2][j];
                    d_scales_log[3 * i + j] = ds * p.s[j];
                }
            }
            if (d_quats != nullptr) {
                const float w = p.qn[0], x = p.qn[1], y = p.qn[2], z = p.qn[3];
                float dqn[4];
                dqn[0] = 2.0f * (-z * dRq[0][1] + y * dRq[0][2] + z * dRq[1][0]
                                 - x * dRq[1][2] - y * dRq[2][0] + x * dRq[2][1]);
                dqn[1] = 2.0f * (y * dRq[0][1] + z * dRq[0][2] + y * dRq[1][0]
                                 - 2.0f * x * dRq[1][1] - w * dRq[1][2] + z * dRq[2][0]
                                 + w * dRq[2][1] - 2.0f * x * dRq[2][2]);
                dqn[2] = 2.0f * (-2.0f * y * dRq[0][0] + x * dRq[0][1] + w * dRq[0][2]
                                 + x * dRq[1][0] + z * dRq[1][2] - w * dRq[2][0]
                                 + z * dRq[2][1] - 2.0f * y * dRq[2][2]);
                dqn[3] = 2.0f * (-2.0f * z * dRq[0][0] - w * dRq[0][1] + x * dRq[0][2]
                                 + w * dRq[1][0] - 2.0f * z * dRq[1][1] + y * dRq[1][2]
                                 + x * dRq[2][0] + y * dRq[2][1]);
                // qn = q / max(|q|, 1e-12)
                float d_qden = 0.0f;
#pragma unroll
                for (int k = 0; k < 4; ++k) d_qden += -dqn[k] * (p.qn[k] / p.qden);
                const float d_qnorm = p.qnorm >= 1e-12f ? d_qden : 0.0f;
                const float q_scale = p.qnorm == 0.0f ? 0.0f : d_qnorm / p.qnorm;
#pragma unroll
                for (int k = 0; k < 4; ++k) d_quats[4 * i + k] = dqn[k] / p.qden + p.q[k] * q_scale;
            }
        }
    }
    if (S::RS > 0 && d_frest != nullptr) {
        __syncthreads();
        stage_out<S::RS, S::SS>(d_frest, base, rows, rest_s);
    }
    if (partial != nullptr) {
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
        for (int k = 0; k < NCAM_GRAD; ++k) {
            float v = gc[k];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
            if (lane == 0) red_s[warp][k] = v;
        }
        __syncthreads();
        if (threadIdx.x < NCAM_GRAD) {
            float acc = red_s[0][threadIdx.x];
#pragma unroll
            for (int wi = 1; wi < WARPS; ++wi) acc += red_s[wi][threadIdx.x];
            partial[(long long)threadIdx.x * gridDim.x + blockIdx.x] = acc;
        }
    }
}

// d_cam[k] = sum over blocks of partial[k][b], in a fixed order; the
// intrinsics' entries are 0
__global__ void __launch_bounds__(REDUCE_THREADS) cam_grad_reduce(
    const float* __restrict__ partial, int n_blocks, float* __restrict__ d_cam) {
    __shared__ float s[REDUCE_THREADS];
    const float* col = partial + (long long)blockIdx.x * n_blocks;
    float acc = 0.0f;
    for (int b = threadIdx.x; b < n_blocks; b += REDUCE_THREADS) acc += col[b];
    s[threadIdx.x] = acc;
    __syncthreads();
    for (int w = REDUCE_THREADS / 2; w > 0; w >>= 1) {
        if ((int)threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
        __syncthreads();
    }
    if (threadIdx.x == 0) d_cam[blockIdx.x] = s[0];
    if (blockIdx.x == 0 && threadIdx.x < NCAM - NCAM_GRAD) d_cam[NCAM_GRAD + threadIdx.x] = 0.0f;
}

template <int D>
int launch_fwd(const float* means, const float* scales_log, const float* quats,
               const float* fdc, const float* frest, const float* cam,
               const long long* deg_ptr, int deg_val, int n, int img_w, int img_h,
               int use_vel, float* means2d, float* depths, float* conics, float* radii,
               float* comps, float* pix_vels, unsigned char* valid, float* extents,
               float* colors, cudaStream_t s) {
    const unsigned blocks = (unsigned)((n + BLOCK - 1) / BLOCK);
    project_sh_fwd_kernel<D><<<blocks, BLOCK, 0, s>>>(
        means, scales_log, quats, fdc, frest, cam, deg_ptr, deg_val, n, img_w, img_h, use_vel,
        means2d, depths, conics, radii, comps, pix_vels, valid, extents, colors);
    return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const float* means, const float* scales_log, const float* quats,
               const float* fdc, const float* frest, const float* cam,
               const long long* deg_ptr, int deg_val, int n, int img_w, int img_h,
               int use_vel, const float* g_means2d, const float* g_depths,
               const float* g_conics, const float* g_comps, const float* g_pix_vels,
               const float* g_colors, float* d_means, float* d_scales_log, float* d_quats,
               float* d_fdc, float* d_frest, float* partial, float* d_cam, cudaStream_t s) {
    const unsigned blocks = (unsigned)((n + BLOCK - 1) / BLOCK);
    project_sh_bwd_kernel<D><<<blocks, BLOCK, 0, s>>>(
        means, scales_log, quats, fdc, frest, cam, deg_ptr, deg_val, n, img_w, img_h, use_vel,
        g_means2d, g_depths, g_conics, g_comps, g_pix_vels, g_colors, d_means, d_scales_log,
        d_quats, d_fdc, d_frest, d_cam != nullptr ? partial : nullptr);
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0 || d_cam == nullptr) return err;
    cam_grad_reduce<<<NCAM_GRAD, REDUCE_THREADS, 0, s>>>(partial, (int)blocks, d_cam);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n_rest: features_rest's rows a Gaussian (0, 3, 8 or 15: SH degree 0-3).
// deg_ptr: the active degree as an int64 on the device, or null to use
// deg_val. Every pointer is to a contiguous float32 (valid: bool) tensor.
extern "C" int project_sh_fwd_f32(
    const float* means, const float* scales_log, const float* quats, const float* fdc,
    const float* frest, const float* cam, const long long* deg_ptr, int deg_val, int n,
    int n_rest, int img_w, int img_h, int use_vel, float* means2d, float* depths,
    float* conics, float* radii, float* comps, float* pix_vels, unsigned char* valid,
    float* extents, float* colors, void* stream) {
    if (n == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PROJECT_SH_FWD(D)                                                                  \
    launch_fwd<D>(means, scales_log, quats, fdc, frest, cam, deg_ptr, deg_val, n, img_w,  \
                  img_h, use_vel, means2d, depths, conics, radii, comps, pix_vels, valid, \
                  extents, colors, s)
    switch (n_rest) {
        case 0: return PROJECT_SH_FWD(0);
        case 3: return PROJECT_SH_FWD(1);
        case 8: return PROJECT_SH_FWD(2);
        case 15: return PROJECT_SH_FWD(3);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef PROJECT_SH_FWD
}

// The gradients in are contiguous float32 of the forward outputs' shapes.
// A null d_* skips that gradient; d_cam (22 floats) null skips the camera's,
// else partial holds 18 * ceil(n / 128) floats of scratch.
extern "C" int project_sh_bwd_f32(
    const float* means, const float* scales_log, const float* quats, const float* fdc,
    const float* frest, const float* cam, const long long* deg_ptr, int deg_val, int n,
    int n_rest, int img_w, int img_h, int use_vel, const float* g_means2d,
    const float* g_depths, const float* g_conics, const float* g_comps,
    const float* g_pix_vels, const float* g_colors, float* d_means, float* d_scales_log,
    float* d_quats, float* d_fdc, float* d_frest, float* partial, float* d_cam,
    void* stream) {
    if (n == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PROJECT_SH_BWD(D)                                                                  \
    launch_bwd<D>(means, scales_log, quats, fdc, frest, cam, deg_ptr, deg_val, n, img_w,  \
                  img_h, use_vel, g_means2d, g_depths, g_conics, g_comps, g_pix_vels,      \
                  g_colors, d_means, d_scales_log, d_quats, d_fdc, d_frest, partial, d_cam, s)
    switch (n_rest) {
        case 0: return PROJECT_SH_BWD(0);
        case 3: return PROJECT_SH_BWD(1);
        case 8: return PROJECT_SH_BWD(2);
        case 15: return PROJECT_SH_BWD(3);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef PROJECT_SH_BWD
}
