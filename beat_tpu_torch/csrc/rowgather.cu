// K5 on Hopper: the plain row gather out[i, :] = tbl[clip(idx[i]), :].
//
// Replaces the Pallas TPU kernel beat_tpu/ops/rowgather.py::_gather_rows_call
// (:34, pallas_call at :73; public entry gather_rows_pallas, :87): per-row
// asynchronous HBM->VMEM copies through a ring of 64 DMA semaphores, over
// rows padded to (8, L) tiles.  Neither the padding nor the semaphore ring
// has a counterpart here.
//
// tbl is (R, M) float32, idx (n,) int32 or int64 with any element stride,
// out (n, M) float32.  The index is read in the type it comes in and clipped
// to [0, R-1] in 64 bits here, so an int64 index beyond the int32 range
// cannot wrap and the caller runs no index pass of its own: one call is one
// device kernel.  (The TPU entry casts to int32 before it clips,
// rowgather.py:109.)
//
// Bound: device-memory bandwidth: each gathered row read once and written
// once, 2*n*M*4 bytes (fewer reads where rows repeat), no arithmetic.  At the
// SMC's shape (2000 x 1504, 24 MB) that is below the cost of one launch.
//
// Design: the output is one flat array of n*m vectors (float4 where
// M % 4 == 0 and both arrays are 16-byte aligned, else float: source and
// destination rows are then misaligned against each other).  A block of 128
// threads owns kUnroll * 128 consecutive output vectors, whatever rows they
// fall in, so short rows share a block and long rows are cut over many.
// Every thread first starts its kUnroll independent loads (index, then
// vector), then its stores: kUnroll 16-byte loads in flight per thread for
// any M.  The loads go through the read-only path; the stores are streaming
// (evict first), so the output does not push table rows that repeat out of
// L2.  A thread finds its row with one 64-bit division a block and one
// 32-bit division a vector.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;

template <typename vec_t, typename idx_t>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const vec_t* __restrict__ tbl, const idx_t* __restrict__ idx,
                   int64_t idx_stride, vec_t* __restrict__ out, int64_t R, uint32_t m,
                   int64_t total) {
    const int64_t base = (int64_t)blockIdx.x * (kThreads * kUnroll);
    const int64_t q0 = base / m;                       // the block's first row
    const uint32_t col0 = (uint32_t)(base - q0 * m) + threadIdx.x;
    vec_t v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
        if (base + threadIdx.x + k * kThreads < total) {
            const uint32_t col = col0 + k * kThreads;  // < m + kThreads * kUnroll
            const uint32_t dq = col / m;
            int64_t r = (int64_t)idx[(q0 + dq) * idx_stride];
            r = r < 0 ? 0 : (r > R - 1 ? R - 1 : r);
            v[k] = __ldg(tbl + r * m + (col - dq * m));
        }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
        const int64_t e = base + threadIdx.x + k * kThreads;
        if (e < total) __stcs(out + e, v[k]);
    }
}

template <typename vec_t, typename idx_t>
int launch(const float* tbl, const void* idx, int64_t idx_stride, float* out, int64_t R,
           int64_t n, int64_t m, cudaStream_t stream) {
    const int64_t total = n * m;
    const int64_t blocks = (total + kThreads * kUnroll - 1) / (kThreads * kUnroll);
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    gather_rows_kernel<vec_t, idx_t><<<(unsigned int)blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const vec_t*>(tbl), static_cast<const idx_t*>(idx), idx_stride,
        reinterpret_cast<vec_t*>(out), R, (uint32_t)m, total);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry, bound with ctypes.  Pointers are device pointers; tbl and
// out are contiguous, idx has `idx_bytes` (4 or 8) bytes an element and
// `idx_stride` elements between entries.  The launch goes on `stream`
// (PyTorch's current stream) and does not synchronise.  Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int beat_gather_rows_f32(const float* tbl, const void* idx, int idx_bytes,
                                    int64_t idx_stride, float* out, int64_t R, int64_t n,
                                    int M, void* stream) {
    if (n <= 0 || M <= 0) return 0;
    if (R <= 0 || (idx_bytes != 4 && idx_bytes != 8)) return (int)cudaErrorInvalidValue;
    const bool vec4 = M % 4 == 0 && (reinterpret_cast<uintptr_t>(tbl) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    const cudaStream_t s = (cudaStream_t)stream;
    if (vec4) {
        return idx_bytes == 8
                   ? launch<float4, int64_t>(tbl, idx, idx_stride, out, R, n, M / 4, s)
                   : launch<float4, int32_t>(tbl, idx, idx_stride, out, R, n, M / 4, s);
    }
    return idx_bytes == 8 ? launch<float, int64_t>(tbl, idx, idx_stride, out, R, n, M, s)
                          : launch<float, int32_t>(tbl, idx, idx_stride, out, R, n, M, s);
}
