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
// Layout: data is the natural (T, P, D, S, N) array (float32, or bfloat16
// below).  A (d, s) cell
// of a patch is one contiguous row of N floats.  The TPU's lane-transposed
// (T, P, N, D*S_pad) stacking layout, its one-hot selection matmuls and its
// 128-chain / 8-patch padding exist because the TPU has no cheap gather; none
// of them has a counterpart here.
//
// Operands come as the caller has them: every per-chain array is addressed
// through its own chain stride (and sidx, stf through a target stride, 0 when
// all targets share the onsets), so nothing is expanded or copied for the
// launch.  Indices are clamped to the grid here (d, s in [1, D-1] x [1, S-1]
// for K3, [0, D-1] x [0, S-1] for K4), so no index reads outside the library.
//
// Bound: device-memory bandwidth (the library read once, the indices and
// weights, the output); the operations, 2*CORNERS flops per row float, come
// to about 60 % of that time at 2000 chains.  What a kernel really has to
// move is C*T*P*CORNERS rows to the threads that sum them, 25 times the
// library at 2000 chains (98 GB at the Laquila shape).  Two variants, chosen
// by ops/gfstack.py::plan_stack from the shapes (a bf16 library has a third,
// `mma`, below):
//
// `gather` (gf_stack_kernel): one block per (target, 8 chains, n tile); a
// thread keeps 8 sums of V samples in registers and pulls every row straight
// from the library.  All C*T*P*CORNERS rows cross the L2 -> SM path unless L1
// happens to hold them, and that path bounds it (with all chains on one cell,
// where L1 serves 7 of a block's 8 chains, it takes a third of the time).  It
// stays for shapes where a staged cell row would be read less often than it
// costs to stage (few chains, or K4 on a short walk over the patches), for
// cell tiles that do not fit shared memory and for N % 4 != 0.
//
// `tiled` (gf_stack_tiled_kernel; gf_stack_tiled_fed_kernel, `tiled_fed`):
// a block of 512 summing threads owns (target, n tile of 4*LANES samples,
// chain tile of 16 * 512/LANES chains) and walks the patches.  For each patch
// the whole (D*S x n tile) cell tile of data[t, p] comes into shared memory
// once, into the other of two buffers while the sums of the present patch
// run, and every chain of the tile takes its CORNERS rows from there.  L2 -> SM traffic
// falls from C*T*P*CORNERS rows to the library times the number of chain
// tiles (4 at 2000 chains and LANES = 16); blocks of one (target, n tile) are
// neighbours in the grid, so their chain tiles stream the same cells through
// L2 together.  LANES threads spread along n serve one chain: a shared-memory
// read is one contiguous row segment (conflict-free) and the chain's weights
// are a broadcast.  A thread keeps 16 chains x 4 samples of sums in registers.
// Per (chain, patch) one 16-byte entry {slip*rf, slip*(1-rf), sf, row offset}
// (K4: {slip, offset}) gives a chain its weights and rows; a chunk of patches
// of entries lies in shared memory, swizzled so that neither its writes nor
// its reads conflict.  Two bodies feed the sums:
//
// - `tiled_fed` (K3 on float32 with shared onsets; variant 3): an entry serves
//   every target and n tile, so gf_stack_fold_kernel folds each once a call
//   into an array the wrapper allocates (chain tile, chunk, the swizzled
//   entries: one contiguous run a chunk), in about 0.05 ms at 5000 chains.
//   A 17th warp, the producer, has one thread issue every copy: per chunk one
//   cp.async.bulk of its entries, per patch one TMA load of its cell tile (a
//   5-d tensor map over data whose box is one (t, p)'s D x S x n tile; it
//   fills the ragged n tile with zeros), each into the other of two buffers,
//   its bytes counted on the buffer's `full` mbarrier; every summing thread
//   arrives on the buffer's `empty` one when done with it.  The 16 summing
//   warps only wait and sum: no fold, no copy instruction, no __syncthreads
//   in the walk.  The producer earns its machinery: the halfway design (the
//   fold once a call, the summing threads copying its entries and the cell
//   tiles by cp.async; BEAT_ABLATE & 32) takes 12.12 ms against 9.71 at the
//   Laquila shape and 5000 chains, 4.73 against 3.76 at 2000 (H100, PERF.md).
// - `tiled` (per-target onsets, K4, bf16): each block folds the entries of
//   a chunk of patches from the operands itself between two __syncthreads
//   (with shared onsets the blocks of the other targets and n tiles fold the
//   same entries again, 98 times at the Laquila shape and 5000 chains), and
//   its threads copy the next cell tile by 16-byte cp.async, one barrier a
//   patch.  Per-target onsets would make the fed body's array T times larger.
//
// At D*S = 320 the two cell tiles of 64 samples take 160 KB, and 8 patches of
// entries (in-block) or two buffers of 4 (fed) 64 KB, of the 227 KB a block
// may use.  What bounds both is shared memory: the reads of the C*T*P*CORNERS
// rows at 128 bytes a clock and SM (a quarter of the float32 rate).  In the
// in-block body the fold and the copies, issued by the summing warps and
// passing through the same unit, do not hide behind them; the fed body takes
// them off those warps.  tools/bench_torch_stack.py --ablate reads each
// part's share of the time from builds with parts left out; PERF.md has the
// numbers.
//
// A library in bfloat16 (half the bytes; the JAX package's
// BEAT_TPU_STACK_DTYPE=bfloat16) runs K3 on a third variant, `mma`
// (gf_stack_mma_kernel), where its shapes allow it (ops/gfstack.py::plan_stack;
// `tiled` and `gather` run on bf16 too, templated on the element type: a row
// of 4 samples is an 8-byte load, widened to float32 in registers by a shift
// of its bits).  What bounds `tiled` on bf16 is not bytes: halving them bought
// 18 % (5.62 -> 4.60 ms at the Laquila shape, H100), since every chain still
// issues its own shared-memory reads of its 4 rows, widens each sample and
// sums it with a CUDA-core FMA.  `mma` moves the sums to the tensor cores.
// The stack at patch p is A_p (chains x cells) @ B_p (cells x n), A_p with 4
// nonzeros a row; with the samples as the product's M and 8 chains as its N,
// mma.sync.m16n8k16 takes the 4 corner rows of each of the 8 chains as its K,
// straight from the staged cell tile by ldmatrix.trans with a row address per
// lane: the gather of the staged rows costs nothing beside the load.  The
// chains' weights are the B fragment, built in registers (each lane holds the
// weights of one chain of the 8 at 2 k positions, zeros elsewhere).  The block
// is the tiled one's (512 threads, a (target, 64 samples, 512 chains) tile
// walking the patches, the cell tile of the next patch copied by cp.async
// while this one is summed, the folded operands of a chunk of patches in
// shared memory); a warp keeps 4 groups x 4 m16 tiles of (16 x 8) float32 sums
// in registers over all patches and stores each output once.  A phase of
// ldmatrix (8 rows x 16 bytes) conflicts on random cells unless the rows are
// placed for it: chunk c of the row of cell (d, s) lies at chunk c ^ (2 (s &
// 1) + 4 (d & 1)), so a chain's 4 corners fill the 4 even (or the 4 odd)
// chunks, and the second chain of each 8-row phase reads the other half of
// its m16 tile (its sums' rows are then swapped, m <-> m ^ 8, in the store):
// every phase is conflict-free whatever the cells.  The weights (slip * rf *
// sf ...) are not exact in bf16 (one rounding is 2^-9 relative), so each is
// split into bf16 hi + lo and the tile goes through two products into the
// same float32 sums: |w - hi - lo| <= 2^-18 |w|, the JAX kernel's x3 scheme
// (beat_tpu/ops/gfstack.py:134-152) with the library's own lo term zero,
// since its rows are exact in bf16.  The tensor cores do 8 times the useful
// products (a chain uses 4 of the 32 rows of its group), and twice that for
// hi + lo.  What bounds it is the products: at the Laquila shape on an H100
// a build without the ldmatrix loads of the row gathers (each (chain, corner)
// row read once, C*T*P*4 rows as in `tiled`, now at 16 bytes a lane) takes
// as long as the whole, 3.9 ms, one without the products 3.0; the tile
// copies add 0.7 ms and the fold 0.2 (builds with parts left out,
// tools/bench_torch_stack.py --ablate; PERF.md).  K4 has no
// `mma` body: one built on m16n8k8 with a diagonal B lost to `gather` at the
// Laquila shape (2.25 against 1.70 ms; PERF.md), the copies of the cell tiles
// costing more than one row a chain read straight from the library.  A
// non-finite library sample reaches the other chains of its group through
// their zero weights (0 * inf); libraries are finite.
//
// `tiled` and `gather` add a chain's products in the same order (patches
// ascending, corners in the order above) with the same folded weights and
// float32 FMAs, one plain store per output and no atomics: they are
// deterministic and equal bit for bit.  `mma` adds in another order (the
// tensor cores' own within a product, hi then lo, patches ascending) with one
// plain store per output: it is deterministic (equal to itself from call to
// call) and within the stack's bar of the others, not equal to them.  Ragged
// tiles (C, P, N not multiples of the tile sizes) are masked in the kernels.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// bfloat16 storage: the upper 16 bits of a float32, so widening is a shift
typedef uint16_t bf16_t;

namespace {

constexpr int kChains = 8;        // gather: chains per block, sums in registers
constexpr int kPatchChunk = 32;   // gather: patches staged in shared memory at a time
constexpr int kMaxThreads = 128;  // gather: threads per block
constexpr int kSmemPerBlock = 232448;   // bytes of shared memory a block may use

// The operands of one launch; strides in elements.
struct Strides {
    int64_t didx_c, sidx_c, sidx_t, slips_c, rtf_c, stf_c, stf_t;
};

template <typename E>
struct Operands {
    const E* data;            // (T, P, D, S, N), contiguous, float or bf16_t
    const int32_t* didx;      // [c * didx_c + p]
    const int32_t* sidx;      // [c * sidx_c + t * sidx_t + p]
    const float* slips;       // [c * slips_c + p]
    const float* rtf;         // [c * rtf_c + p]                 (K3)
    const float* stf;         // [c * stf_c + t * stf_t + p]     (K3)
    float* out;               // (C, T, N), contiguous
    int C, T, P, D, S, N;
    Strides st;
};

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

// 4 (V = 4) or 1 samples of a library row, widened to float32: __ldg from
// device memory (row) or a plain load from shared memory (shared)
template <typename E, int V> struct Row;
template <> struct Row<float, 4> {
    static __device__ __forceinline__ float4 ldg(const float* p) {
        return __ldg(reinterpret_cast<const float4*>(p));
    }
    static __device__ __forceinline__ float4 shared(const float* p) {
        return *reinterpret_cast<const float4*>(p);
    }
};
template <> struct Row<float, 1> {
    static __device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
};
__device__ __forceinline__ float4 widen4(const uint2 u) {
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
template <> struct Row<bf16_t, 4> {
    static __device__ __forceinline__ float4 ldg(const bf16_t* p) {
        return widen4(__ldg(reinterpret_cast<const uint2*>(p)));
    }
    static __device__ __forceinline__ float4 shared(const bf16_t* p) {
        return widen4(*reinterpret_cast<const uint2*>(p));
    }
};
template <> struct Row<bf16_t, 1> {
    static __device__ __forceinline__ float ldg(const bf16_t* p) {
        return __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
    }
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// ---------------------------------------------------------------------------
// gather: CORNERS = 4: K3 (multilinear); CORNERS = 1: K4 (nearest neighbour;
// rtf and stf are not read).  grid = (chain tiles, n tiles, T).
//
// How the compiler orders the row loads decides this kernel's time, so two
// things pin it (times at the Laquila shape, 2000 chains, H100): K3 takes a
// chain's first corner before it asks for the other three (a compiler barrier
// between them): 13.0 ms against 15-19 ms with all four loads started at once;
// K4 is held to 8 blocks an SM, which keeps it the faster at the launch-sized
// shapes that stay on this variant.
template <int CORNERS, int V, typename E>
__global__ void __launch_bounds__(kMaxThreads, (CORNERS == 1 ? 8 : 1))
gf_stack_kernel(const E* __restrict__ data,
                const int32_t* __restrict__ didx,
                const int32_t* __restrict__ sidx,
                const float* __restrict__ slips,
                const float* __restrict__ rtf,
                const float* __restrict__ stf,
                float* __restrict__ out,
                int C, int T, int P, int D, int S, int N, const Strides st) {
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
                const int64_t c = c0 + cc;
                const int p = p0 + pp;
                const int d = clampi(didx[c * st.didx_c + p], lo, D - 1);
                const int s = clampi(sidx[c * st.sidx_c + t * st.sidx_t + p], lo, S - 1);
                const float w = slips[c * st.slips_c + p];
                // the first corner's row: (d-1, s-1) for K3, (d, s) for K4
                s_off[pp][cc] = ((((int64_t)t * P + p) * D + (d - lo)) * S + (s - lo)) * N;
                if constexpr (CORNERS == 4) {
                    const float rf = rtf[c * st.rtf_c + p];
                    const float sf = stf[c * st.stf_c + t * st.stf_t + p];
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
                    const E* row = data + s_off[pp][cc] + n0;
                    if constexpr (CORNERS == 4) {
                        const vec_t x0 = Row<E, V>::ldg(row);
                        Vec<V>::fma(acc[cc], s_w[pp][cc][0], x0);
                        asm volatile("" ::: "memory");      // see the note above the kernel
                        const vec_t x1 = Row<E, V>::ldg(row + row_s);
                        const vec_t x2 = Row<E, V>::ldg(row + row_d);
                        const vec_t x3 = Row<E, V>::ldg(row + row_d + row_s);
                        Vec<V>::fma(acc[cc], s_w[pp][cc][1], x1);
                        Vec<V>::fma(acc[cc], s_w[pp][cc][2], x2);
                        Vec<V>::fma(acc[cc], s_w[pp][cc][3], x3);
                    } else {
                        const vec_t x0 = Row<E, V>::ldg(row);
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

template <int CORNERS, typename E>
int launch_gather(const Operands<E>& a, bool vec4, cudaStream_t stream) {
    const int columns = vec4 ? a.N / 4 : a.N;
    int threads = ((columns + 31) / 32) * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    const int n_tiles = (columns + threads - 1) / threads;
    if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((a.C + kChains - 1) / kChains, n_tiles, a.T);
    if (vec4) {
        gf_stack_kernel<CORNERS, 4, E><<<grid, threads, 0, stream>>>(
            a.data, a.didx, a.sidx, a.slips, a.rtf, a.stf, a.out, a.C, a.T, a.P, a.D, a.S, a.N,
            a.st);
    } else {
        gf_stack_kernel<CORNERS, 1, E><<<grid, threads, 0, stream>>>(
            a.data, a.didx, a.sidx, a.slips, a.rtf, a.stf, a.out, a.C, a.T, a.P, a.D, a.S, a.N,
            a.st);
    }
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tiled

// Measurement builds only (tools/bench_torch_stack.py --ablate):
// -DBEAT_ABLATE=n leaves parts of the tiled and mma kernels out (1: the fold
// of the entries after the first chunk, or for the fed body the fold
// launch; 2: the tile copies after the first two, and for the fed body the
// copies of the entries too; 4: the sums; mma only, 8: the tensor core
// products, 16: the ldmatrix loads), so that each part's share of the time
// can be read on a machine where no kernel profiler runs.  Such a build
// computes nothing of use, except 32: variant 3 runs the fed body's halfway
// design instead (the entries folded once a call, each block's summing
// threads copying them and its cell tiles by cp.async), which computes the
// same output.
#ifndef BEAT_ABLATE
#define BEAT_ABLATE 0
#endif

constexpr int kTiledThreads = 512;      // 16 warps, one block an SM
constexpr int kChainsPerThread = 16;    // 16 chains x 4 samples of sums: 64 registers

// 4 samples of a row into shared memory: 16 bytes of float (cp.async.cg, L2
// only), 8 bytes of bf16_t (cp.async.ca, the size .cg does not take)
template <typename E>
__device__ __forceinline__ void cp_async_4samples(void* smem, const void* gmem) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    if constexpr (sizeof(E) == 4) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
                     : "memory");
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem)
                     : "memory");
    }
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The folded operands of one (chain, patch).
template <int CORNERS> struct Entry;
template <> struct Entry<4> {
    using type = float4;      // {slip*rf, slip*(1-rf), sf, bits of the first corner's row offset}
    static __device__ __forceinline__ float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};
template <> struct Entry<1> {
    using type = float2;      // {slip, bits of the cell's row offset}
    static __device__ __forceinline__ float2 zero() { return make_float2(0.f, 0.f); }
};

// The entries of patches p0 .. p0 + chunk for the CT chains from c0 (nc of
// them live; nc >= 1), folded by THREADS threads (this one `tid`) from the
// operands: entry (cc, pp) lies at
// cc * chunk + (pp ^ (cc % chunk)).  Consecutive threads read consecutive
// patches of one chain (whole 32-byte sectors at a chunk of 8) and write one
// line of shared memory; two neighbouring chains read at one patch fall into
// different banks.  Entries beyond the chains or the patches are zero: weight
// 0 on row code 0.  row_code(d - lo, s - lo) is the variant's code of the first
// corner's row (its offset in the tile, or its index).
// UNROLL entries at a time have their loads in flight together.
template <int CORNERS, int THREADS, int CT, int UNROLL = 1, typename E, typename RowCode>
__device__ __forceinline__ void fold_chunk(const Operands<E>& a, int t, int c0, int nc, int p0,
                                           int chunk_shift, typename Entry<CORNERS>::type* ents,
                                           RowCode row_code, int tid) {
    const int chunk_mask = (1 << chunk_shift) - 1;
    const int lo = CORNERS == 4 ? 1 : 0;
    auto one = [&](int i) {
        const int cc = i >> chunk_shift, pp = i & chunk_mask;
        const bool ok = cc < nc && p0 + pp < a.P;
        // a masked entry loads (c0, p0), which exists, and is zeroed below:
        // the loads stand clear of any branch
        const int64_t c = c0 + (ok ? cc : 0);
        const int p = p0 + (ok ? pp : 0);
        const int d = clampi(__ldg(a.didx + c * a.st.didx_c + p), lo, a.D - 1);
        const int s = clampi(__ldg(a.sidx + c * a.st.sidx_c + t * a.st.sidx_t + p), lo, a.S - 1);
        const float w = __ldg(a.slips + c * a.st.slips_c + p);
        const float off = __int_as_float(row_code(d - lo, s - lo));
        typename Entry<CORNERS>::type e;
        if constexpr (CORNERS == 4) {
            const float rf = __ldg(a.rtf + c * a.st.rtf_c + p);
            const float sf = __ldg(a.stf + c * a.st.stf_c + t * a.st.stf_t + p);
            e = make_float4(w * rf, w * (1.0f - rf), sf, off);
        } else {
            e = make_float2(w, off);
        }
        ents[(cc << chunk_shift) + (pp ^ (cc & chunk_mask))] = ok ? e : Entry<CORNERS>::zero();
    };
    if constexpr (UNROLL == 1) {
        for (int i = tid; i < (CT << chunk_shift); i += THREADS) one(i);
    } else {
#pragma unroll UNROLL
        for (int i = tid; i < (CT << chunk_shift); i += THREADS) one(i);
    }
}

// grid = (chain tiles, n tiles, T); kTiledThreads threads; dynamic shared
// memory: two cell tiles of D*S x 4*LANES elements of E, then
// CT << chunk_shift entries (FOLDED: two buffers of them).  FOLDED (a
// measurement build only, BEAT_ABLATE & 32: the fed body's halfway design)
// copies each chunk of entries from `folded`, as gf_stack_fold_kernel lays
// them out, by cp.async with the cell tiles instead of folding it.
template <int CORNERS, int LANES, typename E, bool FOLDED = false>
__global__ void __launch_bounds__(kTiledThreads, 1)
gf_stack_tiled_kernel(const Operands<E> a, const int chunk_shift,
                      const float4* __restrict__ folded) {
    using entry_t = typename Entry<CORNERS>::type;
    constexpr int THREADS = kTiledThreads, CPT = kChainsPerThread;
    constexpr int NT = 4 * LANES;             // samples of the n tile
    constexpr int G = THREADS / LANES;        // chains served at a time
    constexpr int CT = G * CPT;               // chains of the tile
    extern __shared__ __align__(16) unsigned char smem[];

    const int P = a.P, S = a.S;
    const int DS = a.D * S;
    E* const tiles = reinterpret_cast<E*>(smem);
    entry_t* const ents = reinterpret_cast<entry_t*>(tiles + 2 * DS * NT);
    const int chunk_mask = (1 << chunk_shift) - 1;

    const int c0 = blockIdx.x * CT;
    const int n0 = blockIdx.y * NT;
    const int t = blockIdx.z;
    const int nc = min(CT, a.C - c0);
    const int lane = threadIdx.x % LANES;     // this thread's 4 samples of the tile
    const int g = threadIdx.x / LANES;        // its chains: g, g + G, g + 2 G, ...
    const bool live = n0 + 4 * lane < a.N;

    // the cell tile of patch p into buffer buf: row r of the tile is cell r of
    // data[t, p], samples n0 .. n0 + NT
    auto copy_tile = [&](int p, int buf) {
        const E* src = a.data + (((int64_t)t * P + p) * DS) * a.N + n0 + 4 * lane;
        E* dst = tiles + buf * DS * NT + 4 * lane;
        if (live) {
            for (int r = g; r < DS; r += G) {
                cp_async_4samples<E>(dst + r * NT, src + (int64_t)r * a.N);
            }
        }
        cp_async_commit();
    };

    auto fold = [&](int p0) {
        fold_chunk<CORNERS, THREADS, CT>(a, t, c0, nc, p0, chunk_shift, ents,
                                         [&](int d, int s) { return (d * S + s) * NT; },
                                         threadIdx.x);
    };
    // FOLDED: the entries of chunk k into buffer k & 1, in the tile's copy group
    const int n_ents = CT << chunk_shift;
    auto copy_entries = [&](int k) {
        const float4* src =
            folded + ((int64_t)blockIdx.x * ((P + chunk_mask) >> chunk_shift) + k) * n_ents;
        entry_t* dst = ents + (k & 1) * n_ents;
        for (int i = threadIdx.x; i < n_ents; i += THREADS) {
            cp_async_4samples<float>(dst + i, src + i);
        }
    };

    float4 acc[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] = Vec<4>::zero();

    // the CORNERS rows of chain j * G + g at patch slot pp of the chunk
    auto add_chain = [&](int j, int pp, const E* tile, int slot) {
        const int cc = j * G + g;
        const entry_t e = ents[slot + (cc << chunk_shift) + (pp ^ (cc & chunk_mask))];
        if constexpr (CORNERS == 4) {
            const E* row = tile + __float_as_int(e.w);
            const float4 x0 = Row<E, 4>::shared(row);
            const float4 x1 = Row<E, 4>::shared(row + NT);
            const float4 x2 = Row<E, 4>::shared(row + S * NT);
            const float4 x3 = Row<E, 4>::shared(row + S * NT + NT);
            const float u = 1.0f - e.z;
            Vec<4>::fma(acc[j], e.x * e.z, x0);       // (d-1, s-1)
            Vec<4>::fma(acc[j], e.x * u, x1);         // (d-1, s)
            Vec<4>::fma(acc[j], e.y * e.z, x2);       // (d,   s-1)
            Vec<4>::fma(acc[j], e.y * u, x3);         // (d,   s)
        } else {
            const E* row = tile + __float_as_int(e.y);
            Vec<4>::fma(acc[j], e.x, Row<E, 4>::shared(row));
        }
    };

    if constexpr (FOLDED) copy_entries(0);
    copy_tile(0, 0);
    for (int p = 0; p < P; ++p) {
        const int buf = p & 1;
        const int pp = p & chunk_mask;
        cp_async_wait_all();                  // this thread's share of tile p has landed
        __syncthreads();                      // tile p is whole; patch p - 1 is summed by all
        if (p + 1 < P && !((BEAT_ABLATE & 2) && p > 0)) {
            // FOLDED: the next chunk's buffer held the last chunk's entries
            if (FOLDED && ((p + 1) & chunk_mask) == 0) copy_entries((p + 1) >> chunk_shift);
            copy_tile(p + 1, buf ^ 1);        // lands while patch p is summed
        }
        if (!FOLDED && pp == 0 && !((BEAT_ABLATE & 1) && p > 0)) {
            fold(p);
            __syncthreads();
        }
        if (BEAT_ABLATE & 4) continue;
        const E* tile = tiles + buf * DS * NT + 4 * lane;
        const int slot = FOLDED ? ((p >> chunk_shift) & 1) * n_ents : 0;
        // K3 on a whole chain tile runs its chains without a branch between
        // them, so the reads of one overlap the sums of the last; measured,
        // K4 (one row a chain) is faster with the branch
        if (CORNERS == 4 && nc == CT) {
#pragma unroll
            for (int j = 0; j < CPT; ++j) add_chain(j, pp, tile, slot);
        } else {
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
                if (j * G < nc) add_chain(j, pp, tile, slot);     // same for the whole block
            }
        }
    }
    if (!live) return;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
        const int cc = j * G + g;
        if (cc < nc) {
            float* o = a.out + ((int64_t)(c0 + cc) * a.T + t) * a.N + n0 + 4 * lane;
            *reinterpret_cast<float4*>(o) = acc[j];
        }
    }
}

template <int CORNERS, int LANES, typename E, bool FOLDED = false>
int launch_tiled(const Operands<E>& a, int chunk_shift, cudaStream_t stream,
                 const float4* folded = nullptr) {
    constexpr int NT = 4 * LANES, CT = kTiledThreads / LANES * kChainsPerThread;
    const size_t smem = (size_t)2 * a.D * a.S * NT * sizeof(E) +
                        ((size_t)(FOLDED ? 2 : 1) * CT << chunk_shift) *
                            sizeof(typename Entry<CORNERS>::type);
    const int n_tiles = (a.N + NT - 1) / NT;
    if (smem > kSmemPerBlock || n_tiles > 65535) return (int)cudaErrorInvalidValue;
    auto kernel = gf_stack_tiled_kernel<CORNERS, LANES, E, FOLDED>;
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
    const dim3 grid((a.C + CT - 1) / CT, n_tiles, a.T);
    kernel<<<grid, kTiledThreads, smem, stream>>>(a, chunk_shift, folded);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tiled, fed (K3 on float32 libraries with shared onsets)

constexpr int kFoldThreads = 256;
constexpr int kFedThreads = kTiledThreads + 32;     // 16 summing warps and a producer warp

// The entries of every chain tile of CT chains and every chunk of 1 <<
// chunk_shift patches, as the tiled kernel folds them into shared memory:
// chunk k of tile blockIdx.y at (blockIdx.y * gridDim.x + k) * (CT <<
// chunk_shift), swizzled within, zero past the chains and the patches.
// The onsets are every target's (target stride 0), so one entry serves all
// targets and n tiles.  grid = (chunks, chain tiles).
template <int CT>
__global__ void __launch_bounds__(kFoldThreads)
gf_stack_fold_kernel(const Operands<float> a, float4* __restrict__ folded, const int chunk_shift,
                     const int nt) {
    const int c0 = blockIdx.y * CT;
    float4* const ents = folded + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) *
                                      ((int64_t)CT << chunk_shift);
    const int S = a.S;
    fold_chunk<4, kFoldThreads, CT, 4>(a, 0, c0, min(CT, a.C - c0),
                                       (int)blockIdx.x << chunk_shift, chunk_shift, ents,
                                       [&](int d, int s) { return (d * S + s) * nt; },
                                       threadIdx.x);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrive and expect `bytes` of copies on this phase
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n" ::"r"(bar),
        "r"(parity)
        : "memory");
}
// `bytes` (a multiple of 16) from global to shared memory, completed on `bar`
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}
// the box of `map` at (c0 .. c4) into shared memory, completed on `bar`
__device__ __forceinline__ void tensor_load_5d(unsigned dst, const CUtensorMap* map, int c0,
                                               int c1, int c2, int c3, int c4, unsigned bar) {
    asm volatile(
        "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], "
        "[%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
        "r"(bar)
        : "memory");
}

// grid = (chain tiles, n tiles, T); kFedThreads threads; dynamic shared
// memory: two cell tiles of D*S x 4*LANES floats, two buffers of CT <<
// chunk_shift entries, then 8 barriers.  `cells` maps data (T, P, D, S, N)
// with a box of one (t, p)'s D x S x 4*LANES samples, the tile's layout;
// samples past N are filled with zeros.  `folded` holds the entries of
// gf_stack_fold_kernel.  Warps 0-15 sum as gf_stack_tiled_kernel<4, LANES,
// float> does, product for product; warp 16 has one thread issue every
// copy.  Per buffer a `full` barrier (the producer's arrival and the copy's
// bytes) and an `empty` one (every summing thread's arrival).
template <int LANES>
__global__ void __launch_bounds__(kFedThreads, 1)
gf_stack_tiled_fed_kernel(const Operands<float> a, const __grid_constant__ CUtensorMap cells,
                          const float4* __restrict__ folded, const int chunk_shift) {
    constexpr int CPT = kChainsPerThread, NT = 4 * LANES, G = kTiledThreads / LANES;
    constexpr int CT = G * CPT;
    extern __shared__ __align__(128) unsigned char fed_smem[];    // TMA: 128-byte aligned

    const int P = a.P, S = a.S;
    const int DS = a.D * S;
    const int chunk_mask = (1 << chunk_shift) - 1;
    const int n_ents = CT << chunk_shift;
    float* const tiles = reinterpret_cast<float*>(fed_smem);
    float4* const ents = reinterpret_cast<float4*>(tiles + 2 * DS * NT);
    // barrier i of buffer b: tile full, tile empty, entries full, entries empty
    const unsigned bars = smem_addr(ents + 2 * n_ents);
    auto bar = [&](int i, int b) { return bars + 8 * (2 * i + b); };

    const int c0 = blockIdx.x * CT;
    const int n0 = blockIdx.y * NT;
    const int t = blockIdx.z;
    const int nc = min(CT, a.C - c0);

    if (threadIdx.x == 0) {
        for (int b = 0; b < 2; ++b) {
            mbar_init(bar(0, b), 1);
            mbar_init(bar(1, b), kTiledThreads);
            mbar_init(bar(2, b), 1);
            mbar_init(bar(3, b), kTiledThreads);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= kTiledThreads) {
        if (threadIdx.x > kTiledThreads) return;
        // the producer: the chunk of entries a patch starts, then its tile,
        // each into the buffer its use two before has released
        const unsigned tile_bytes = DS * NT * sizeof(float), ent_bytes = n_ents * sizeof(float4);
        const float4* src =
            folded + (int64_t)blockIdx.x * ((P + chunk_mask) >> chunk_shift) * n_ents;
        for (int p = 0; p < P; ++p) {
            if ((p & chunk_mask) == 0) {
                const int k = p >> chunk_shift, b = k & 1;
                if (k >= 2) mbar_wait(bar(3, b), ((k >> 1) - 1) & 1);
                if ((BEAT_ABLATE & 2) && k >= 2) {
                    mbar_arrive(bar(2, b));
                } else {
                    mbar_expect(bar(2, b), ent_bytes);
                    bulk_load(smem_addr(ents + b * n_ents), src + (int64_t)k * n_ents, ent_bytes,
                              bar(2, b));
                }
            }
            const int b = p & 1;
            if (p >= 2) mbar_wait(bar(1, b), ((p >> 1) - 1) & 1);
            if ((BEAT_ABLATE & 2) && p >= 2) {
                mbar_arrive(bar(0, b));
            } else {
                mbar_expect(bar(0, b), tile_bytes);
                tensor_load_5d(smem_addr(tiles + b * DS * NT), &cells, n0, 0, 0, p, t, bar(0, b));
            }
        }
        return;
    }

    const int lane = threadIdx.x % LANES;     // this thread's 4 samples of the tile
    const int g = threadIdx.x / LANES;        // its chains: g, g + G, g + 2 G, ...
    const bool live = n0 + 4 * lane < a.N;

    float4 acc[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] = Vec<4>::zero();

    // the 4 rows of chain j * G + g at patch slot pp of the chunk
    auto add_chain = [&](int j, int pp, const float* tile, const float4* chunk) {
        const int cc = j * G + g;
        const float4 e = chunk[(cc << chunk_shift) + (pp ^ (cc & chunk_mask))];
        const float* row = tile + __float_as_int(e.w);
        const float4 x0 = Row<float, 4>::shared(row);
        const float4 x1 = Row<float, 4>::shared(row + NT);
        const float4 x2 = Row<float, 4>::shared(row + S * NT);
        const float4 x3 = Row<float, 4>::shared(row + S * NT + NT);
        const float u = 1.0f - e.z;
        Vec<4>::fma(acc[j], e.x * e.z, x0);       // (d-1, s-1)
        Vec<4>::fma(acc[j], e.x * u, x1);         // (d-1, s)
        Vec<4>::fma(acc[j], e.y * e.z, x2);       // (d,   s-1)
        Vec<4>::fma(acc[j], e.y * u, x3);         // (d,   s)
    };

    for (int p = 0; p < P; ++p) {
        const int b = p & 1, pp = p & chunk_mask, k = p >> chunk_shift, eb = k & 1;
        if (pp == 0) mbar_wait(bar(2, eb), (k >> 1) & 1);
        mbar_wait(bar(0, b), (p >> 1) & 1);
        if (!(BEAT_ABLATE & 4)) {
            const float* tile = tiles + b * DS * NT + 4 * lane;
            const float4* chunk = ents + eb * n_ents;
            if (nc == CT) {
#pragma unroll
                for (int j = 0; j < CPT; ++j) add_chain(j, pp, tile, chunk);
            } else {
#pragma unroll
                for (int j = 0; j < CPT; ++j) {
                    if (j * G < nc) add_chain(j, pp, tile, chunk);    // same for the whole block
                }
            }
        }
        mbar_arrive(bar(1, b));
        if (pp == chunk_mask || p == P - 1) mbar_arrive(bar(3, eb));
    }
    if (!live) return;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
        const int cc = j * G + g;
        if (cc < nc) {
            float* o = a.out + ((int64_t)(c0 + cc) * a.T + t) * a.N + n0 + 4 * lane;
            *reinterpret_cast<float4*>(o) = acc[j];
        }
    }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t rc = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t rc =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p)
                   : nullptr;
    }();
    return fn;
}

// The fed body's shared memory; 0 where it cannot run: the tensor map's box
// takes at most 256 cells along D and along S
template <int LANES>
size_t fed_smem(const Operands<float>& a, int chunk_shift) {
    constexpr int CT = kTiledThreads / LANES * kChainsPerThread;
    if (a.D > 256 || a.S > 256) return 0;
    return (size_t)2 * a.D * a.S * 4 * LANES * sizeof(float) +
           ((size_t)2 * CT << chunk_shift) * sizeof(float4) + 8 * sizeof(uint64_t);
}

template <int LANES>
int launch_tiled_fed(const Operands<float>& a, const float4* folded, int chunk_shift,
                     cudaStream_t stream) {
    constexpr int NT = 4 * LANES, CT = kTiledThreads / LANES * kChainsPerThread;
    const size_t smem = fed_smem<LANES>(a, chunk_shift);
    const int n_tiles = (a.N + NT - 1) / NT;
    const EncodeTiled encode = encode_tiled();
    if (smem == 0 || smem > kSmemPerBlock || n_tiles > 65535 || folded == nullptr ||
        encode == nullptr) {
        return (int)cudaErrorInvalidValue;
    }
    CUtensorMap cells;
    const cuuint64_t N = a.N, S = a.S, D = a.D, P = a.P;
    const cuuint64_t dims[5] = {N, S, D, P, (cuuint64_t)a.T};
    const cuuint64_t strides[4] = {N * 4, S * N * 4, D * S * N * 4, P * D * S * N * 4};
    const cuuint32_t box[5] = {NT, (cuuint32_t)a.S, (cuuint32_t)a.D, 1, 1};
    const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
    if (encode(&cells, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<float*>(a.data), dims,
               strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
        return (int)cudaErrorInvalidValue;
    }
    auto kernel = gf_stack_tiled_fed_kernel<LANES>;
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
    const dim3 grid((a.C + CT - 1) / CT, n_tiles, a.T);
    kernel<<<grid, kFedThreads, smem, stream>>>(a, cells, folded, chunk_shift);
    return (int)cudaGetLastError();
}

template <int LANES>
int launch_fold(const Operands<float>& a, float4* folded, int chunk_shift, cudaStream_t stream) {
    constexpr int CT = kTiledThreads / LANES * kChainsPerThread;
    const int chain_tiles = (a.C + CT - 1) / CT;
    if (chain_tiles > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((a.P + (1 << chunk_shift) - 1) >> chunk_shift, chain_tiles);
    gf_stack_fold_kernel<CT><<<grid, kFoldThreads, 0, stream>>>(a, folded, chunk_shift,
                                                                4 * LANES);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// mma (K3 on bf16 libraries)

constexpr int kMmaThreads = 512;        // 16 warps, one block an SM
constexpr int kMmaNT = 64;              // samples of the n tile: a tile row is 128 bytes, 8 chunks
constexpr int kMmaTiles = kMmaNT / 16;  // m16 tiles along the n tile
constexpr int kMmaGroups = 4;           // 8-chain groups of a warp: 4 x 4 tiles x 4 sums = 64 registers
constexpr int kMmaCT = kMmaThreads / 32 * kMmaGroups * 8;     // 512 chains a block
constexpr int kMmaRowBytes = kMmaNT * 2;

__device__ __forceinline__ void cp_async_16(unsigned dst, const void* gmem) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// four 8 x 8 b16 matrices, transposed: lanes 8j .. 8j + 7 give the addresses
// of matrix j's 8 rows (16 bytes each); lane l receives rows 2 (l % 4) and
// 2 (l % 4) + 1 of column l / 4 of each
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

// d += A (16 x 16, bf16) @ B (16 x 8, bf16), float32 sums
__device__ __forceinline__ void mma_k16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                        unsigned b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w0, w1 as bf16 hi + lo pairs (round to nearest, |w - hi - lo| <= 2^-18 |w|):
// w0 in the low 16 bits of each, w1 in the high
__device__ __forceinline__ void split_bf16x2(float w0, float w1, unsigned& hi, unsigned& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(w0, w1);
    hi = *reinterpret_cast<const unsigned*>(&h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(w0 - __uint_as_float(hi << 16),
                                                   w1 - __uint_as_float(hi & 0xffff0000u));
    lo = *reinterpret_cast<const unsigned*>(&l);
}

// grid = (chain tiles, n tiles, T); kMmaThreads threads; dynamic shared
// memory: two cell tiles of D*S rows x kMmaNT bf16 samples, then
// kMmaCT << chunk_shift entries.  Warp w sums the 8-chain groups 4 w .. 4 w + 3
// of the chain tile over the whole n tile.
//
// At patch p a group's K is its 8 chains' 32 corner rows, two k16 steps h of
// 4 chains each, k = 4 (chain - 4 h) + corner (corners in the order (d-1,
// s-1), (d-1, s), (d, s-1), (d, s)).  The entry's row code is (r << 3) | f
// with r the first corner's row (d-1) S + (s-1) and f = 2 ((s-1) & 1) + 4
// ((d-1) & 1) its chunk swizzle; corner k & 3 lies at row r + (k & 1) + (k >>
// 1 & 1) S with swizzle f ^ 2 (k & 3).
__global__ void __launch_bounds__(kMmaThreads, 1)
gf_stack_mma_kernel(const Operands<bf16_t> a, const int chunk_shift) {
    using entry_t = Entry<4>::type;
    constexpr int THREADS = kMmaThreads, NT = kMmaNT, MT = kMmaTiles, GR = kMmaGroups;
    constexpr int CT = kMmaCT, RB = kMmaRowBytes;
    extern __shared__ __align__(16) unsigned char smem[];

    const int P = a.P, S = a.S, N = a.N;
    const int DS = a.D * S;
    entry_t* const ents = reinterpret_cast<entry_t*>(smem + 2 * DS * RB);
    const int chunk_mask = (1 << chunk_shift) - 1;
    const unsigned tiles = (unsigned)__cvta_generic_to_shared(smem);

    const int c0 = blockIdx.x * CT;
    const int n0 = blockIdx.y * NT;
    const int t = blockIdx.z;
    const int nc = min(CT, a.C - c0);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, q = lane & 3;    // the fragments' groupID, thread in group

    // the cell tile of patch p into buffer buf: chunk c (samples n0 + 8c ..
    // n0 + 8c + 7) of row r (cell (d, s) of data[t, p]) at chunk c ^ (2 (s &
    // 1) + 4 (d & 1)).  This thread copies chunk c = threadIdx.x % 8 of rows
    // r0, r0 + 64, ... (r0 = threadIdx.x / 8), (d, s) stepped without a
    // division.  Chunks beyond N are never copied; they are zeroed once below,
    // since a product mixes the samples of a tile's rows (0 * NaN is NaN).
    constexpr int ROWS = THREADS / 8;         // rows a pass of the block copies
    const int copy_c = threadIdx.x & 7, copy_r0 = threadIdx.x >> 3;
    const bool copy_live = n0 + 8 * copy_c < N;
    const int copy_d0 = copy_r0 / S, copy_s0 = copy_r0 - copy_d0 * S;
    const int step_d = ROWS / S, step_s = ROWS - step_d * S;
    auto copy_tile = [&](int p, int buf) {
        if (copy_live) {
            const bf16_t* src = a.data + ((int64_t)t * P + p) * DS * N + n0 + 8 * copy_c;
            const unsigned dst = tiles + buf * DS * RB;
            int d = copy_d0, sc = copy_s0;
            for (int r = copy_r0; r < DS; r += ROWS) {
                const int f = 2 * (sc & 1) + 4 * (d & 1);
                cp_async_16(dst + r * RB + ((copy_c ^ f) << 4), src + (int64_t)r * N);
                d += step_d;
                sc += step_s;
                if (sc >= S) {
                    sc -= S;
                    ++d;
                }
            }
        }
        cp_async_commit();
    };

    auto fold = [&](int p0) {
        fold_chunk<4, THREADS, CT, 4>(
            a, t, c0, nc, p0, chunk_shift, ents,
            [&](int d, int s) { return ((d * S + s) << 3) | (2 * (s & 1) + 4 * (d & 1)); },
            threadIdx.x);
    };

    float acc[GR][MT][4];
#pragma unroll
    for (int gr = 0; gr < GR; ++gr)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[gr][mt][v] = 0.0f;

    // this lane's B values (k = 2q, 2q+1 of half `slot & 1` of step `slot >>
    // 1`) are chain g's when g = 4 h + 2 half + (q >> 1), so at most one slot
    // of the four holds weights: slot g >> 1, where g & 1 == q >> 1.  This
    // lane's A row address serves k = (lane & 7) + 8 (lane >> 4) of each step:
    // chain 4 h + a_chain, corner lane & 3, read at the half (lane >> 3 & 1) ^
    // (lane >> 2 & 1) of the m16 tile.
    const int b_slot = (g & 1) == (q >> 1) ? g >> 1 : -1;
    const unsigned a_chain = ((lane >> 2) & 1) + 2 * (lane >> 4);
    const unsigned corner = lane & 3;
    const unsigned a_offset =
        ((corner & 1) + (corner >> 1) * S) * RB + ((((lane >> 3) & 1) ^ ((lane >> 2) & 1)) << 4);
    const unsigned a_flip = 2u * corner;

    if (n0 + NT > N) {
        for (int i = threadIdx.x; i < 2 * DS * 8; i += THREADS) {
            if (n0 + 8 * (i & 7) >= N) {
                const int r = (i >> 3) % DS, d = r / S;
                const int f = 2 * ((r - d * S) & 1) + 4 * (d & 1);
                *reinterpret_cast<uint4*>(smem + (i >> 3) * RB + (((i & 7) ^ f) << 4)) =
                    make_uint4(0u, 0u, 0u, 0u);
            }
        }
    }
    copy_tile(0, 0);
    // the buffer of patch p, carried from patch to patch: computed as p & 1
    // the same loop took 3 % longer at the Laquila shape (3.99 against 3.88
    // ms in turns, H100; tools/bench_torch_stack.py)
    int buf = 0;
    for (int p = 0; p < P; ++p) {
        const int pp = p & chunk_mask;
        cp_async_wait_all();                  // this thread's share of tile p has landed
        __syncthreads();                      // tile p is whole; patch p - 1 is summed by all
        if (p + 1 < P && !((BEAT_ABLATE & 2) && p > 0)) {
            copy_tile(p + 1, buf ^ 1);        // lands while patch p is summed
        }
        if (pp == 0 && !((BEAT_ABLATE & 1) && p > 0)) {
            fold(p);
            __syncthreads();
        }
        const unsigned tile = tiles + buf * DS * RB;
        buf ^= 1;
        if (BEAT_ABLATE & 4) continue;
        // first every group's operands: its B fragments (hi, lo) and this
        // lane's A row addresses; then the products, a group at a time, its
        // ldmatrix loads ahead of its mma
        unsigned bh[GR], bl[GR], base[GR][2], f[GR][2];
#pragma unroll
        for (int gr = 0; gr < GR; ++gr) {
            const int cc = (warp * GR + gr) * 8 + g;
            const entry_t e = ents[(cc << chunk_shift) + (pp ^ (cc & chunk_mask))];
            // chain g's weights at corners 2 (q & 1), 2 (q & 1) + 1
            const float wa = (q & 1) ? e.y : e.x;
            split_bf16x2(wa * e.z, wa * (1.0f - e.z), bh[gr], bl[gr]);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const unsigned m =
                    __shfl_sync(0xffffffffu, __float_as_uint(e.w), 4 * (4 * h + a_chain));
                f[gr][h] = (m & 7u) ^ a_flip;
                base[gr][h] = tile + (m >> 3) * RB + a_offset;
            }
        }
#pragma unroll
        for (int gr = 0; gr < GR; ++gr) {
            if ((warp * GR + gr) * 8 >= nc) continue;     // the same for the whole warp
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                unsigned A[MT][4];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    if (!(BEAT_ABLATE & 16)) {
                        ldmatrix_x4_trans(A[mt], base[gr][h] + (((2u * mt) ^ f[gr][h]) << 4));
                    } else {
                        A[mt][0] = A[mt][1] = A[mt][2] = A[mt][3] = base[gr][h] + mt;
                    }
                }
                const bool s0 = b_slot == 2 * h, s1 = b_slot == 2 * h + 1;
#pragma unroll
                for (int hl = 0; hl < 2; ++hl) {
                    const unsigned b = hl ? bl[gr] : bh[gr];
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                        if (BEAT_ABLATE & 8) {
                            acc[gr][mt][0] +=
                                __uint_as_float(A[mt][0] ^ A[mt][1] ^ A[mt][2] ^ A[mt][3]);
                        } else {
                            mma_k16(acc[gr][mt], A[mt], s0 ? b : 0u, s1 ? b : 0u);
                        }
                    }
                }
            }
        }
    }

    // the sums: this lane holds rows g, g + 8 of columns 2q, 2q + 1 of each
    // group's m16 tiles; row m of an odd chain is sample m ^ 8 of its tile
#pragma unroll
    for (int gr = 0; gr < GR; ++gr) {
        const int cb = (warp * GR + gr) * 8;
#pragma unroll
        for (int col = 0; col < 2; ++col) {
            const int cc = cb + 2 * q + col;
            if (cc >= nc) continue;
            float* o = a.out + ((int64_t)(c0 + cc) * a.T + t) * N + n0;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int n = 16 * mt + 8 * (half ^ col) + g;
                    if (n0 + n < N) o[n] = acc[gr][mt][2 * half + col];
                }
            }
        }
    }
}

int launch_mma(const Operands<bf16_t>& a, int chunk_shift, cudaStream_t stream) {
    const size_t smem = (size_t)2 * a.D * a.S * kMmaRowBytes +
                        ((size_t)kMmaCT << chunk_shift) * sizeof(Entry<4>::type);
    const int n_tiles = (a.N + kMmaNT - 1) / kMmaNT;
    if (smem > kSmemPerBlock || n_tiles > 65535) return (int)cudaErrorInvalidValue;
    const cudaError_t rc = cudaFuncSetAttribute(
        gf_stack_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
    const dim3 grid((a.C + kMmaCT - 1) / kMmaCT, n_tiles, a.T);
    gf_stack_mma_kernel<<<grid, kMmaThreads, smem, stream>>>(a, chunk_shift);
    return (int)cudaGetLastError();
}

// variant 0: gather; 1: tiled with `lanes` threads along n a chain (16 or 8)
// and 1 << chunk_shift patches of entries; 2: mma (K3 on bf16 only) with 1 <<
// chunk_shift patches of entries; 3: tiled_fed with the entries `folded` by
// beat_gf_stack_fold_f32 at the same lanes and chunk_shift (K3 on float32
// with shared onsets only).  The tiled variants need rows of 4-sample
// columns aligned to their size (16 bytes of float, 8 of bf16_t), mma rows
// of 8-sample chunks on 16-byte boundaries (N % 8 == 0).
template <int CORNERS, typename E>
int launch(const Operands<E>& a, int variant, int lanes, int chunk_shift, const void* folded,
           cudaStream_t stream) {
    if (a.C <= 0 || a.T <= 0 || a.N <= 0) return 0;
    if (a.P < 0 || a.D < 1 + (CORNERS == 4) || a.S < 1 + (CORNERS == 4) || a.T > 65535) {
        return (int)cudaErrorInvalidValue;
    }
    // 4-sample columns need every row aligned: N % 4 == 0 and aligned bases
    const bool vec4 = a.N % 4 == 0 &&
                      (reinterpret_cast<uintptr_t>(a.data) % (4 * sizeof(E)) == 0) &&
                      (reinterpret_cast<uintptr_t>(a.out) % 16 == 0);
    if (variant == 0) return launch_gather<CORNERS, E>(a, vec4, stream);
    if (chunk_shift < 0 || chunk_shift > 5 || a.P == 0) return (int)cudaErrorInvalidValue;
    if (variant == 2) {
        // mma: K3, bf16 rows of 8-sample chunks on 16-byte boundaries
        if constexpr (CORNERS == 4 && sizeof(E) == 2) {
            if (a.N % 8 == 0 && reinterpret_cast<uintptr_t>(a.data) % 16 == 0) {
                return launch_mma(a, chunk_shift, stream);
            }
        }
        return (int)cudaErrorInvalidValue;
    }
    if (variant == 3) {
        // tiled fed: K3, float32, every target on the same onsets
        if constexpr (CORNERS == 4 && sizeof(E) == 4) {
            if (vec4 && a.st.sidx_t == 0 && a.st.stf_t == 0) {
                const float4* f = static_cast<const float4*>(folded);
                if constexpr ((BEAT_ABLATE & 32) != 0) {       // the halfway design
                    if (f == nullptr) return (int)cudaErrorInvalidValue;
                    if (lanes == 16) return launch_tiled<4, 16, E, true>(a, chunk_shift, stream, f);
                    if (lanes == 8) return launch_tiled<4, 8, E, true>(a, chunk_shift, stream, f);
                    return (int)cudaErrorInvalidValue;
                }
                if (lanes == 16) return launch_tiled_fed<16>(a, f, chunk_shift, stream);
                if (lanes == 8) return launch_tiled_fed<8>(a, f, chunk_shift, stream);
            }
        }
        return (int)cudaErrorInvalidValue;
    }
    if (variant != 1 || !vec4) {
        return (int)cudaErrorInvalidValue;
    }
    if (lanes == 16) return launch_tiled<CORNERS, 16, E>(a, chunk_shift, stream);
    if (lanes == 8) return launch_tiled<CORNERS, 8, E>(a, chunk_shift, stream);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entries, bound with ctypes.  Pointers are device pointers; data and
// out are contiguous, the other arrays have unit stride along the patches and
// the given strides (in elements) along chains and targets.  `variant`,
// `lanes` and `chunk_shift` are the plan of ops/gfstack.py::plan_stack;
// `folded` is the entries of beat_gf_stack_fold_f32 for variant 3, else
// null.  The launch goes on `stream` (PyTorch's current stream) and does not
// synchronise.  Each returns cudaGetLastError() after the launch (0 =
// success).

// K3: data (T,P,D,S,N) f32; didx, slips, rtf (C,P); sidx, stf (C,T,P) or,
// with a target stride of 0, (C,1,P); out (C,T,N) f32.
extern "C" int beat_gf_stack_multilinear_f32(
    const float* data, const int32_t* didx, const int32_t* sidx, const float* slips,
    const float* rtf, const float* stf, float* out, int C, int T, int P, int D, int S, int N,
    int64_t didx_c, int64_t sidx_c, int64_t sidx_t, int64_t slips_c, int64_t rtf_c,
    int64_t stf_c, int64_t stf_t, int variant, int lanes, int chunk_shift, const void* folded,
    void* stream) {
    const Operands<float> a{data, didx, sidx, slips, rtf, stf, out, C, T, P, D, S, N,
                            {didx_c, sidx_c, sidx_t, slips_c, rtf_c, stf_c, stf_t}};
    return launch<4>(a, variant, lanes, chunk_shift, folded, (cudaStream_t)stream);
}

// K4: as K3 without rtf and stf.
extern "C" int beat_gf_stack_nearest_f32(
    const float* data, const int32_t* didx, const int32_t* sidx, const float* slips, float* out,
    int C, int T, int P, int D, int S, int N, int64_t didx_c, int64_t sidx_c, int64_t sidx_t,
    int64_t slips_c, int variant, int lanes, int chunk_shift, const void* folded,
    void* stream) {
    const Operands<float> a{data, didx, sidx, slips, nullptr, nullptr, out, C, T, P, D, S, N,
                            {didx_c, sidx_c, sidx_t, slips_c, 0, 0, 0}};
    return launch<1>(a, variant, lanes, chunk_shift, folded, (cudaStream_t)stream);
}

// K3 and K4 on a bf16 library (bits of torch.bfloat16); the other operands and
// the output as above, float32.
extern "C" int beat_gf_stack_multilinear_bf16(
    const uint16_t* data, const int32_t* didx, const int32_t* sidx, const float* slips,
    const float* rtf, const float* stf, float* out, int C, int T, int P, int D, int S, int N,
    int64_t didx_c, int64_t sidx_c, int64_t sidx_t, int64_t slips_c, int64_t rtf_c,
    int64_t stf_c, int64_t stf_t, int variant, int lanes, int chunk_shift, const void* folded,
    void* stream) {
    const Operands<bf16_t> a{data, didx, sidx, slips, rtf, stf, out, C, T, P, D, S, N,
                             {didx_c, sidx_c, sidx_t, slips_c, rtf_c, stf_c, stf_t}};
    return launch<4>(a, variant, lanes, chunk_shift, folded, (cudaStream_t)stream);
}

extern "C" int beat_gf_stack_nearest_bf16(
    const uint16_t* data, const int32_t* didx, const int32_t* sidx, const float* slips,
    float* out, int C, int T, int P, int D, int S, int N, int64_t didx_c, int64_t sidx_c,
    int64_t sidx_t, int64_t slips_c, int variant, int lanes, int chunk_shift,
    const void* folded, void* stream) {
    const Operands<bf16_t> a{data, didx, sidx, slips, nullptr, nullptr, out, C, T, P, D, S,
                             N, {didx_c, sidx_c, sidx_t, slips_c, 0, 0, 0}};
    return launch<1>(a, variant, lanes, chunk_shift, folded, (cudaStream_t)stream);
}

// The entries of K3's variant 3 (float32, shared onsets): didx, slips, rtf
// (C,P); sidx, stf (C,1,P), their target strides unread; folded holds
// ceil(C / CT) * CT * ceil(P / chunk) * chunk entries of 16 bytes, CT =
// 8192 / lanes chains a tile and chunk = 1 << chunk_shift.  A build with
// BEAT_ABLATE & 1 launches nothing (measurement builds).
extern "C" int beat_gf_stack_fold_f32(
    const int32_t* didx, const int32_t* sidx, const float* slips, const float* rtf,
    const float* stf, void* folded, int C, int P, int D, int S, int64_t didx_c,
    int64_t sidx_c, int64_t slips_c, int64_t rtf_c, int64_t stf_c, int lanes, int chunk_shift,
    void* stream) {
    if (C <= 0) return 0;
    if (P <= 0 || D < 2 || S < 2 || chunk_shift < 0 || chunk_shift > 5) {
        return (int)cudaErrorInvalidValue;
    }
    if (BEAT_ABLATE & 1) return 0;
    const Operands<float> a{nullptr, didx, sidx, slips, rtf, stf, nullptr, C, 1, P, D, S, 0,
                            {didx_c, sidx_c, 0, slips_c, rtf_c, stf_c, 0}};
    float4* f = static_cast<float4*>(folded);
    if (lanes == 16) return launch_fold<16>(a, f, chunk_shift, (cudaStream_t)stream);
    if (lanes == 8) return launch_fold<8>(a, f, chunk_shift, (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}
