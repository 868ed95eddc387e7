// K3 and K4 on Hopper: the kinematic Green's-function stack.
//
// Replace the Pallas TPU kernels beat_tpu/ops/gfstack.py::_multilinear_kernel
// (K3, :241) and ::_nearest_kernel (K4, :218), both launched by
// stack_batched_pallas (:269, pallas_call at :342).  For the library
// data[t, p, d, s, n] and a lockstep batch of C chains,
//
//   K3:  out[c, t, n] = sum_p slip[c,p] * ( rf*sf         * data[t, p, d-1, s-1, n]
//                                         + rf*(1-sf)     * data[t, p, d-1, s,   n]
//                                         + (1-rf)*sf     * data[t, p, d,   s-1, n]
//                                         + (1-rf)*(1-sf) * data[t, p, d,   s,   n] )
//        with d = didx[c,p] (ceil duration index), s = sidx[c,t,p] (ceil
//        starttime index), rf = rtf[c,p], sf = stf[c,t,p] the floor-cell
//        weights.  The weights are used as given: a starttime beyond the grid
//        has sf outside [0, 1] and the stack extrapolates, as the TPU kernel
//        and the XLA gather do.
//   K4:  out[c, t, n] = sum_p slip[c,p] * data[t, p, d, s, n]   (one cell).
//
// Layout: data is the natural (T, P, D, S, N) float32 array.  A (d, s) cell
// of a patch is one contiguous row of N floats, so a cell is one coalesced
// row read.  The TPU's lane-transposed (T, P, N, D*S_pad) stacking layout,
// its one-hot selection matmuls and its 128-chain / 8-patch padding exist
// because the TPU has no cheap gather; none of them has a counterpart here.
//
// Design: one block per (target t, tile of kChains chains, tile of n).  A
// thread owns V consecutive samples (V = 4, float4, when N % 4 == 0; else 1)
// of every chain of the tile and keeps those kChains * V sums in registers.
// The block walks the P patches in chunks: its threads first turn the chunk's
// indices and weights into one 64-bit row offset and CORNERS weights per
// (patch, chain) in shared memory, then every thread adds the CORNERS
// weighted rows of each chain.  One plain store per output, no atomics, float32
// accumulation: the result is deterministic.  Ragged tiles (C, P, N not
// multiples of the tile sizes) are masked in the kernel.  Indices are
// clamped to the grid here (d, s in [1, D-1] x [1, S-1] for K3, [0, D-1] x
// [0, S-1] for K4), so no index reads outside the library.
//
// Bound: device-memory bandwidth (the library read once, the indices and
// weights, the output); the operations, 2*CORNERS flops per row float, come
// to about half of that time at 2000 chains.  This kernel reads
// C*T*P*CORNERS rows through L2, each row many times over the batch: blocks
// of one target walk the patches together, so the cells of a (t, p) pair
// (D*S*N*4 bytes) stay in L2 while they are wanted.  It therefore runs at
// L2 speed, well above the bound.  Streaming the library once (cell tiles in
// shared memory, TMA) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 8;        // chains per block: accumulators in registers
constexpr int kPatchChunk = 32;   // patches staged in shared memory at a time
constexpr int kMaxThreads = 128;

template <int V> struct Vec;
template <> struct Vec<4> {
    using type = float4;
    static __device__ __forceinline__ float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
    static __device__ __forceinline__ void fma(float4& acc, float w, const float4 x) {
        acc.x = fmaf(w, x.x, acc.x);
        acc.y = fmaf(w, x.y, acc.y);
        acc.z = fmaf(w, x.z, acc.z);
        acc.w = fmaf(w, x.w, acc.w);
    }
};
template <> struct Vec<1> {
    using type = float;
    static __device__ __forceinline__ float zero() { return 0.f; }
    static __device__ __forceinline__ void fma(float& acc, float w, const float x) {
        acc = fmaf(w, x, acc);
    }
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// CORNERS = 4: K3 (multilinear); CORNERS = 1: K4 (nearest neighbour; rtf and
// stf are not read).  grid = (chain tiles, n tiles, T).
template <int CORNERS, int V>
__global__ void __launch_bounds__(kMaxThreads)
gf_stack_kernel(const float* __restrict__ data,
                const int32_t* __restrict__ didx,     // (C, P)
                const int32_t* __restrict__ sidx,     // (C, T, P)
                const float* __restrict__ slips,      // (C, P)
                const float* __restrict__ rtf,        // (C, P)
                const float* __restrict__ stf,        // (C, T, P)
                float* __restrict__ out,              // (C, T, N)
                int C, int T, int P, int D, int S, int N) {
    using vec_t = typename Vec<V>::type;
    __shared__ int64_t s_off[kPatchChunk][kChains];
    __shared__ float s_w[kPatchChunk][kChains][CORNERS];

    const int c0 = blockIdx.x * kChains;
    const int t = blockIdx.z;
    const int nc = min(kChains, C - c0);
    const int64_t n0 = ((int64_t)blockIdx.y * blockDim.x + threadIdx.x) * V;
    const bool live = n0 < N;
    const int64_t row_s = N;                  // next starttime cell
    const int64_t row_d = (int64_t)S * N;     // next duration cell
    const int lo = CORNERS == 4 ? 1 : 0;

    vec_t acc[kChains];
#pragma unroll
    for (int cc = 0; cc < kChains; ++cc) acc[cc] = Vec<V>::zero();

    for (int p0 = 0; p0 < P; p0 += kPatchChunk) {
        const int pn = min(kPatchChunk, P - p0);
        __syncthreads();                      // the previous chunk is consumed
        for (int i = threadIdx.x; i < kChains * kPatchChunk; i += blockDim.x) {
            const int cc = i / kPatchChunk, pp = i % kPatchChunk;
            if (cc < nc && pp < pn) {
                const int c = c0 + cc, p = p0 + pp;
                const int64_t cp = (int64_t)c * P + p;
                const int64_t ctp = ((int64_t)c * T + t) * P + p;
                const int d = clampi(didx[cp], lo, D - 1);
                const int s = clampi(sidx[ctp], lo, S - 1);
                const float w = slips[cp];
                // the first corner's row: (d-1, s-1) for K3, (d, s) for K4
                s_off[pp][cc] = ((((int64_t)t * P + p) * D + (d - lo)) * S + (s - lo)) * N;
                if constexpr (CORNERS == 4) {
                    const float rf = rtf[cp], sf = stf[ctp];
                    s_w[pp][cc][0] = w * rf * sf;                      // (d-1, s-1)
                    s_w[pp][cc][1] = w * rf * (1.0f - sf);             // (d-1, s)
                    s_w[pp][cc][2] = w * (1.0f - rf) * sf;             // (d,   s-1)
                    s_w[pp][cc][3] = w * (1.0f - rf) * (1.0f - sf);    // (d,   s)
                } else {
                    s_w[pp][cc][0] = w;
                }
            }
        }
        __syncthreads();
        if (!live) continue;
        for (int pp = 0; pp < pn; ++pp) {
#pragma unroll
            for (int cc = 0; cc < kChains; ++cc) {
                if (cc < nc) {
                    const float* row = data + s_off[pp][cc] + n0;
                    if constexpr (CORNERS == 4) {
                        const vec_t x0 = __ldg(reinterpret_cast<const vec_t*>(row));
                        const vec_t x1 = __ldg(reinterpret_cast<const vec_t*>(row + row_s));
                        const vec_t x2 = __ldg(reinterpret_cast<const vec_t*>(row + row_d));
                        const vec_t x3 = __ldg(reinterpret_cast<const vec_t*>(row + row_d + row_s));
                        Vec<V>::fma(acc[cc], s_w[pp][cc][0], x0);
                        Vec<V>::fma(acc[cc], s_w[pp][cc][1], x1);
                        Vec<V>::fma(acc[cc], s_w[pp][cc][2], x2);
                        Vec<V>::fma(acc[cc], s_w[pp][cc][3], x3);
                    } else {
                        const vec_t x0 = __ldg(reinterpret_cast<const vec_t*>(row));
                        Vec<V>::fma(acc[cc], s_w[pp][cc][0], x0);
                    }
                }
            }
        }
    }
    if (!live) return;
#pragma unroll
    for (int cc = 0; cc < kChains; ++cc) {
        if (cc < nc) {
            float* o = out + ((int64_t)(c0 + cc) * T + t) * N + n0;
            *reinterpret_cast<vec_t*>(o) = acc[cc];
        }
    }
}

template <int CORNERS>
int launch(const float* data, const int32_t* didx, const int32_t* sidx, const float* slips,
           const float* rtf, const float* stf, float* out, int C, int T, int P, int D,
           int S, int N, cudaStream_t stream) {
    if (C <= 0 || T <= 0 || N <= 0) return 0;
    if (P < 0 || D < 1 + (CORNERS == 4) || S < 1 + (CORNERS == 4) || T > 65535) {
        return (int)cudaErrorInvalidValue;
    }
    // float4 columns need every row 16-byte aligned: N % 4 == 0 and aligned bases
    const bool vec4 = N % 4 == 0 && (reinterpret_cast<uintptr_t>(data) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    const int columns = vec4 ? N / 4 : N;
    int threads = ((columns + 31) / 32) * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    const int n_tiles = (columns + threads - 1) / threads;
    if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((C + kChains - 1) / kChains, n_tiles, T);
    if (vec4) {
        gf_stack_kernel<CORNERS, 4><<<grid, threads, 0, stream>>>(
            data, didx, sidx, slips, rtf, stf, out, C, T, P, D, S, N);
    } else {
        gf_stack_kernel<CORNERS, 1><<<grid, threads, 0, stream>>>(
            data, didx, sidx, slips, rtf, stf, out, C, T, P, D, S, N);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries, bound with ctypes.  Pointers are device pointers of
// contiguous arrays; the launch goes on `stream` (PyTorch's current stream)
// and does not synchronise.  Each returns cudaGetLastError() after the launch
// (0 = success).

// K3: data (T,P,D,S,N) f32; didx, slips, rtf (C,P); sidx, stf (C,T,P);
// out (C,T,N) f32.
extern "C" int beat_gf_stack_multilinear_f32(const float* data, const int32_t* didx,
                                             const int32_t* sidx, const float* slips,
                                             const float* rtf, const float* stf, float* out,
                                             int C, int T, int P, int D, int S, int N,
                                             void* stream) {
    return launch<4>(data, didx, sidx, slips, rtf, stf, out, C, T, P, D, S, N,
                     (cudaStream_t)stream);
}

// K4: as K3 without rtf and stf.
extern "C" int beat_gf_stack_nearest_f32(const float* data, const int32_t* didx,
                                         const int32_t* sidx, const float* slips, float* out,
                                         int C, int T, int P, int D, int S, int N,
                                         void* stream) {
    return launch<1>(data, didx, sidx, slips, nullptr, nullptr, out, C, T, P, D, S, N,
                     (cudaStream_t)stream);
}
