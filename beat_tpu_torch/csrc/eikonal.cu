// The batched eikonal onset solve on Hopper: one launch for the whole solve.
//
// Replaces no Pallas kernel.  The JAX package solves one grid with a
// lax.while_loop (beat_tpu/ops/eikonal.py) and vmaps it over the chains; the
// port's plain version (beat_tpu_torch/ops/eikonal.py::
// eikonal_rupture_times_plain) runs the same Jacobi iteration as about thirty
// elementwise kernels an iteration over the batch, with a host read of the
// active mask every CHECK_EVERY iterations.  This kernel gives the same
// onsets with one launch and no host read.
//
// Per chain (slowness s of an n_dip x n_strike grid, nucleation cell k):
//
//   fh = s * patch_size;  t = 1e8, t[k] = 0
//   repeat up to max_iter times:
//     a = min(t[i-1, j], t[i+1, j]),  b = min(t[i, j-1], t[i, j+1])
//         (a neighbour beyond the edge is the edge cell itself)
//     cand = |a - b| >= fh ? min(a, b) + fh
//                          : 0.5 * (a + b + sqrt(max(2 fh^2 - (a - b)^2, 0)))
//     new = min(t, cand);  new[k] = 0
//     change = sum (new - t)^2;  t = new
//     stop once !(change > epsilon)
//
// Every operation is a float32 intrinsic with round-to-nearest (__fmul_rn,
// __fadd_rn, __fsub_rn, __fsqrt_rn), which nvcc never contracts into an FMA,
// in the order of the plain version, whose every operation is a kernel of
// its own; min and the clamp are PTX's min.NaN and max.NaN, which give NaN
// where an operand is NaN, as torch.minimum and torch.clamp do, in one
// instruction.  So an iteration is bit for bit the plain version's (a NaN's
// payload aside), and only the order of the convergence sum differs: the
// stop decision can differ only where the change lies within float32
// rounding of the sum of epsilon.  Each chain stops at its own iteration, as
// under the JAX package's vmap; a NaN change stops the chain, as
// `active = change > epsilon` does.
//
// Design: one warp per chain.  The chain's grid lives in shared memory for
// the whole solve: two onset buffers (Jacobi: each iteration reads one and
// writes the other) and fh, 12 bytes a cell.  A lane updates the cells
// lane, lane + 32, ... (its row and column stepped, not divided, from one
// cell to the next); one __syncwarp() an iteration orders the writes before
// the next iteration's neighbour reads; a butterfly __shfl_xor_sync sum gives
// every lane the same change, so the lanes stop together, and no block
// barrier is ever taken.  Device memory is read at the start (slowness and
// the two nucleation indexes) and written at the end (onsets, and the
// chain's iteration count).  A block holds as many warps as 48 KiB of shared
// memory allows, at most kMaxWarps: 8 chains of the 10 x 50 grid a block.
//
// Bound: operations and latency, not bytes.  A solve of C chains reads and
// writes 8 C cells bytes (20 MB at 5000 chains of 500 cells, 6 us at 3.35
// TB/s), against about 20 operations a cell an iteration over 45 iterations
// on average (2.3 GFLOP, 34 us at 67 TFLOP/s).  An iteration of a chain is a
// dependent chain of shared-memory reads, the arithmetic and a five-step
// shuffle sum; the design hides that latency behind the other chains' warps
// (32 an SM: four blocks of 8 by shared memory) and spends no barrier beyond
// the warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr int kBlockSmem = 48 * 1024;   // what every device gives a block without opting in
constexpr float kInitTime = 1e8f;

// torch.minimum
__device__ __forceinline__ float tmin(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

// torch.clamp(x, min=0)
__device__ __forceinline__ float clamp0(float x) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(0.0f));
    return r;
}

__device__ __forceinline__ float candidate(float a, float b, float f) {
    const float d = __fsub_rn(a, b);
    const float one_sided = __fadd_rn(tmin(a, b), f);
    const float rad = __fsub_rn(__fmul_rn(2.0f, __fmul_rn(f, f)), __fmul_rn(d, d));
    const float two_sided = __fmul_rn(0.5f, __fadd_rn(__fadd_rn(a, b), __fsqrt_rn(clamp0(rad))));
    return fabsf(d) >= f ? one_sided : two_sided;
}

__global__ void eikonal_kernel(const float* __restrict__ slowness,
                               const int64_t* __restrict__ nuc_dip,
                               const int64_t* __restrict__ nuc_strike, float* __restrict__ out,
                               int32_t* __restrict__ iterations, int C, int nd, int ns,
                               float patch_size, float epsilon, int max_iter) {
    extern __shared__ float smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int chain = blockIdx.x * (blockDim.x >> 5) + warp;
    if (chain >= C) return;
    const int cells = nd * ns;
    float* fh = smem + (size_t)warp * 3 * cells;   // then the two onset buffers

    // the nucleation cell, wrapped as PyTorch's indexing wraps a negative index
    int64_t kd = nuc_dip[chain], ks = nuc_strike[chain];
    kd += kd < 0 ? nd : 0;
    ks += ks < 0 ? ns : 0;
    const bool valid = kd >= 0 && kd < nd && ks >= 0 && ks < ns;
    const int nuc = valid ? (int)(kd * ns + ks) : -1;

    const float* s = slowness + (size_t)chain * cells;
    for (int c = lane; c < cells; c += 32) {
        fh[c] = __fmul_rn(s[c], patch_size);
        fh[cells + c] = c == nuc ? 0.0f : kInitTime;
    }
    __syncwarp();

    // a lane's cells step by 32: di rows and dj columns, carried
    const int di = 32 / ns, dj = 32 % ns;
    int cur = 0, done = max_iter;   // cur: the onset buffer that holds the last iterate
    for (int it = 0; it < max_iter; ++it) {
        const float* t = fh + (1 + cur) * cells;
        float* nxt = fh + (2 - cur) * cells;
        float change = 0.0f;
        int i = lane / ns, j = lane % ns;
        for (int c = lane; c < cells; c += 32) {
            const float up = t[i > 0 ? c - ns : c], down = t[i < nd - 1 ? c + ns : c];
            const float left = t[j > 0 ? c - 1 : c], right = t[j < ns - 1 ? c + 1 : c];
            const float old = t[c];
            float v = tmin(old, candidate(tmin(up, down), tmin(left, right), fh[c]));
            v = c == nuc ? 0.0f : v;
            nxt[c] = v;
            const float dv = __fsub_rn(v, old);
            change = __fadd_rn(change, __fmul_rn(dv, dv));
            i += di;
            j += dj;
            if (j >= ns) {
                j -= ns;
                ++i;
            }
        }
        __syncwarp();
#pragma unroll
        for (int m = 16; m > 0; m >>= 1)
            change = __fadd_rn(change, __shfl_xor_sync(kFull, change, m));
        cur ^= 1;
        if (!(change > epsilon)) {
            done = it + 1;
            break;
        }
    }

    float* o = out + (size_t)chain * cells;
    const float* t = fh + (1 + cur) * cells;
    for (int c = lane; c < cells; c += 32) o[c] = valid ? t[c] : __int_as_float(0x7fc00000);
    if (lane == 0) iterations[chain] = done;
}

}  // namespace

// Plain C entry, bound with ctypes.  Pointers are device pointers to
// contiguous arrays: slowness and out (C, n_dip, n_strike) float32, nuc_dip
// and nuc_strike (C,) int64, iterations (C,) int32 (the updates each chain
// ran).  A nucleation index outside the grid (after a negative one is wrapped)
// gives the chain NaN onsets.  A block takes the most chains that fit 48 KiB
// of shared memory, at most kMaxWarps (at 5000 chains of 10 x 50 cells on an
// H100, 8 a block was the fastest of 1, 2, 3, 4, 6 and 8, by 3 to 7 %).
// The launch goes on `stream` (PyTorch's current stream) and does not
// synchronise.  Returns cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for a grid whose 12 bytes a cell do not fit 48 KiB.
extern "C" int beat_eikonal_f32(const float* slowness, const int64_t* nuc_dip,
                                const int64_t* nuc_strike, float* out, int32_t* iterations,
                                int C, int n_dip, int n_strike, float patch_size, float epsilon,
                                int max_iter, void* stream) {
    if (C <= 0) return 0;
    const int64_t chain_bytes = (int64_t)n_dip * n_strike * 3 * sizeof(float);
    if (n_dip <= 0 || n_strike <= 0 || chain_bytes > kBlockSmem) return (int)cudaErrorInvalidValue;
    int warps = (int)(kBlockSmem / chain_bytes);
    warps = warps > kMaxWarps ? kMaxWarps : warps;
    const int blocks = (C + warps - 1) / warps;
    eikonal_kernel<<<blocks, warps * 32, (size_t)(warps * chain_bytes), (cudaStream_t)stream>>>(
        slowness, nuc_dip, nuc_strike, out, iterations, C, n_dip, n_strike, patch_size, epsilon,
        max_iter < 0 ? 0 : max_iter);
    return (int)cudaGetLastError();
}
