// K1 on Hopper: the blended bilinear row gather of the GF table.
//
// Replaces the Pallas TPU kernel beat_tpu/ops/bilgather.py::_bilinear_rows_call
// (public entry bilinear_rows, bilgather.py:285), which the JAX forward
// reaches from GreensTable.gather_spectra (beat_tpu/heart/gftable.py:390-426).
//
//   out[i, :] = w[i,0]·T[cd, z0] + w[i,1]·T[cd, z0+1]
//             + w[i,2]·T[cd+1, z0] + w[i,3]·T[cd+1, z0+1]
//
// Layout: T is (CD, NZ, M) float32, rows in (channel, distance, depth)
// order, so cd = channel·nd + d0.  M = 12·nf is a multiple of 4: every row
// starts 16-byte aligned and is read and written as float4.  (cd, z0) and
// (cd, z0+1) are adjacent rows; (cd+1, z0) lies NZ·M floats further on.
// The caller clamps cd <= CD-2 and z0 <= NZ-2.  All offsets are 64-bit.
//
// Bound: device-memory bandwidth.  Each query reads 4 rows and writes 1,
// about n·5·M·4 bytes per call, with ~2 flops per byte moved.  The design
// keeps every byte moved exactly once: one thread block per query, its
// threads striding over the row in float4s, the four corner rows blended
// in registers and one row written.  The TPU version's (8, L) tile
// padding, DMA-semaphore ring and transposed scalar-prefetched weights
// have no counterpart here.  TMA/wgmma and fusing the m6 contraction into
// the epilogue (1/6 of the written bytes) are later work.
//
// The blend uses explicitly rounded multiplies and adds in the order of
// the plain PyTorch version (ops/bilgather.py::bilinear_rows_reference),
// so the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float blend(float a, float b, float c, float d,
                                       float w0, float w1, float w2, float w3) {
    float s = __fmul_rn(w0, a);
    s = __fadd_rn(s, __fmul_rn(w1, b));
    s = __fadd_rn(s, __fmul_rn(w2, c));
    return __fadd_rn(s, __fmul_rn(w3, d));
}

__global__ void __launch_bounds__(kThreads)
bilinear_rows_kernel(const float4* __restrict__ tbl,
                     const int32_t* __restrict__ cd,
                     const int32_t* __restrict__ z0,
                     const float* __restrict__ w4,
                     float4* __restrict__ out,
                     int nz, int m4) {
    const int64_t q = blockIdx.x;
    const int64_t row = (int64_t)cd[q] * nz + z0[q];
    const float w0 = w4[4 * q + 0];
    const float w1 = w4[4 * q + 1];
    const float w2 = w4[4 * q + 2];
    const float w3 = w4[4 * q + 3];
    const float4* r00 = tbl + row * m4;
    const float4* r01 = r00 + m4;
    const float4* r10 = r00 + (int64_t)nz * m4;
    const float4* r11 = r10 + m4;
    float4* o = out + q * m4;
    for (int j = threadIdx.x; j < m4; j += kThreads) {
        const float4 a = __ldg(r00 + j);
        const float4 b = __ldg(r01 + j);
        const float4 c = __ldg(r10 + j);
        const float4 d = __ldg(r11 + j);
        float4 r;
        r.x = blend(a.x, b.x, c.x, d.x, w0, w1, w2, w3);
        r.y = blend(a.y, b.y, c.y, d.y, w0, w1, w2, w3);
        r.z = blend(a.z, b.z, c.z, d.z, w0, w1, w2, w3);
        r.w = blend(a.w, b.w, c.w, d.w, w0, w1, w2, w3);
        o[j] = r;
    }
}

}  // namespace

// Plain C entry, bound with ctypes.  Pointers are device pointers; the
// launch goes on `stream` (PyTorch's current stream) and does not
// synchronise.  Returns cudaGetLastError() after the launch (0 = success).
extern "C" int beat_bilinear_rows_f32(const float* tbl, const int32_t* cd,
                                      const int32_t* z0, const float* w4,
                                      float* out, int64_t n, int nz, int m,
                                      void* stream) {
    if (n <= 0) return 0;
    if (m % 4 != 0 || n > 2147483647LL) return (int)cudaErrorInvalidValue;
    bilinear_rows_kernel<<<(unsigned int)n, kThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(tbl), cd, z0, w4,
        reinterpret_cast<float4*>(out), nz, m / 4);
    return (int)cudaGetLastError();
}
