// K5 on Hopper: the plain row gather out[i, :] = tbl[idx[i], :].
//
// Replaces the Pallas TPU kernel beat_tpu/ops/rowgather.py::_gather_rows_call
// (:34, pallas_call at :73; public entry gather_rows_pallas, :87): per-row
// asynchronous HBM->VMEM copies through a ring of 64 DMA semaphores, over
// rows padded to (8, L) tiles.  Neither the padding nor the semaphore ring
// has a counterpart here: a row is read and written by the threads of one
// block, coalesced.
//
// tbl is (R, M) float32, idx (n,) int32, out (n, M) float32.  idx is clipped
// to [0, R-1], as the TPU entry clips it (rowgather.py:109).
//
// Bound: device-memory bandwidth: each gathered row read once and written
// once, 2*n*M*4 bytes (fewer reads where rows repeat), no arithmetic.
// Design: one block per output row.  Where M % 4 == 0 (and both arrays are
// 16-byte aligned) every row starts 16-byte aligned and moves as float4;
// otherwise source and destination rows are misaligned against each other
// and the row moves float by float.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename vec_t>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const vec_t* __restrict__ tbl, const int32_t* __restrict__ idx,
                   vec_t* __restrict__ out, int64_t R, int m) {
    const int64_t q = blockIdx.x;
    int64_t r = idx[q];
    r = r < 0 ? 0 : (r > R - 1 ? R - 1 : r);
    const vec_t* src = tbl + r * m;
    vec_t* dst = out + q * m;
    for (int j = threadIdx.x; j < m; j += kThreads) dst[j] = __ldg(src + j);
}

}  // namespace

// Plain C entry, bound with ctypes.  Pointers are device pointers of
// contiguous arrays; the launch goes on `stream` (PyTorch's current stream)
// and does not synchronise.  Returns cudaGetLastError() after the launch
// (0 = success).
extern "C" int beat_gather_rows_f32(const float* tbl, const int32_t* idx, float* out,
                                    int64_t R, int64_t n, int M, void* stream) {
    if (n <= 0 || M <= 0) return 0;
    if (R <= 0 || n > 2147483647LL) return (int)cudaErrorInvalidValue;
    const bool vec4 = M % 4 == 0 && (reinterpret_cast<uintptr_t>(tbl) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    if (vec4) {
        gather_rows_kernel<float4><<<(unsigned int)n, kThreads, 0, (cudaStream_t)stream>>>(
            reinterpret_cast<const float4*>(tbl), idx, reinterpret_cast<float4*>(out), R, M / 4);
    } else {
        gather_rows_kernel<float><<<(unsigned int)n, kThreads, 0, (cudaStream_t)stream>>>(
            tbl, idx, out, R, M);
    }
    return (int)cudaGetLastError();
}
