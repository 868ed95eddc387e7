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
//
// K2 on Hopper: the weights' cotangent of K1,
//
//   dw4[i, c] = sum_j g[i, j] · corner_c(i)[j],   c in (00, 01, 10, 11).
//
// Replaces the Pallas TPU kernel beat_tpu/ops/bilgather.py::_corner_rows_call
// (:154) together with the einsum that _bil_bwd (:296-304) applies to its
// output.  The TPU kernel writes the four unblended corner rows, (n, 4, M),
// and XLA reduces them against g afterwards: at 60,000 queries that write
// alone is 5.9 GB for a 0.96 MB result.  Here the reduction happens in the
// same pass: g's row and the four corner rows are read once and 4 floats
// are written per query.
//
// Bound: device-memory bandwidth.  At 60,000 queries × M = 6156 it must
// read g once (1.477 GB) and the table at most once (<= 0.228 GB) and write
// 0.96 MB: <= 1.707 GB, about 0.51 ms at 3.35 TB/s, against 2 flops per
// 4 bytes of g.  Design: one block per query, as K1; g is loaded with a
// streaming hint since nothing reads it again.  Its sums run in another
// order than the plain einsum, so the two agree to rounding, not bit for
// bit.  TMA and overlapping K2 with K1 in one step are later work.

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

// K2: dw4[q, c] = sum_j g[q, j] * corner_c(q)[j].  One block per query;
// each thread keeps the four partial sums of its float4 columns, then a
// warp-shuffle and a shared-memory stage reduce them in a fixed order
// (no atomics: the result is deterministic).
__global__ void __launch_bounds__(kThreads)
corner_dot_kernel(const float4* __restrict__ tbl,
                  const int32_t* __restrict__ cd,
                  const int32_t* __restrict__ z0,
                  const float4* __restrict__ g,
                  float* __restrict__ out,
                  int nz, int m4) {
    constexpr int kWarps = kThreads / 32;
    __shared__ float partial[kWarps][4];
    const int64_t q = blockIdx.x;
    const int64_t row = (int64_t)cd[q] * nz + z0[q];
    const float4* r00 = tbl + row * m4;
    const float4* r01 = r00 + m4;
    const float4* r10 = r00 + (int64_t)nz * m4;
    const float4* r11 = r10 + m4;
    const float4* gq = g + q * m4;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    for (int j = threadIdx.x; j < m4; j += kThreads) {
        const float4 v = __ldcs(gq + j);        // streamed: read once
        const float4 a = __ldg(r00 + j);
        const float4 b = __ldg(r01 + j);
        const float4 c = __ldg(r10 + j);
        const float4 d = __ldg(r11 + j);
        s0 += v.x * a.x + v.y * a.y + v.z * a.z + v.w * a.w;
        s1 += v.x * b.x + v.y * b.y + v.z * b.z + v.w * b.w;
        s2 += v.x * c.x + v.y * c.y + v.z * c.z + v.w * c.w;
        s3 += v.x * d.x + v.y * d.y + v.z * d.z + v.w * d.w;
    }
    for (int off = 16; off > 0; off >>= 1) {
        s0 += __shfl_down_sync(0xffffffffu, s0, off);
        s1 += __shfl_down_sync(0xffffffffu, s1, off);
        s2 += __shfl_down_sync(0xffffffffu, s2, off);
        s3 += __shfl_down_sync(0xffffffffu, s3, off);
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
        partial[warp][0] = s0;
        partial[warp][1] = s1;
        partial[warp][2] = s2;
        partial[warp][3] = s3;
    }
    __syncthreads();
    if (warp == 0) {
        s0 = lane < kWarps ? partial[lane][0] : 0.f;
        s1 = lane < kWarps ? partial[lane][1] : 0.f;
        s2 = lane < kWarps ? partial[lane][2] : 0.f;
        s3 = lane < kWarps ? partial[lane][3] : 0.f;
        for (int off = kWarps / 2; off > 0; off >>= 1) {
            s0 += __shfl_down_sync(0xffffffffu, s0, off);
            s1 += __shfl_down_sync(0xffffffffu, s1, off);
            s2 += __shfl_down_sync(0xffffffffu, s2, off);
            s3 += __shfl_down_sync(0xffffffffu, s3, off);
        }
        if (lane == 0) {
            reinterpret_cast<float4*>(out)[q] = make_float4(s0, s1, s2, s3);
        }
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

// K2's plain C entry: g is (n, m) float32, out (n, 4) float32 (16-byte
// aligned, as torch.empty gives it).  Same contract as K1's entry.
extern "C" int beat_corner_dot_f32(const float* tbl, const int32_t* cd,
                                   const int32_t* z0, const float* g,
                                   float* out, int64_t n, int nz, int m,
                                   void* stream) {
    if (n <= 0) return 0;
    if (m % 4 != 0 || n > 2147483647LL) return (int)cudaErrorInvalidValue;
    corner_dot_kernel<<<(unsigned int)n, kThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(tbl), cd, z0,
        reinterpret_cast<const float4*>(g), out, nz, m / 4);
    return (int)cudaGetLastError();
}
