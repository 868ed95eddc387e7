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
// `tiled` (gf_stack_tiled_kernel): a block of 512 threads owns (target, n
// tile of 4*LANES samples, chain tile of 16 * 512/LANES chains) and walks the
// patches.  For each patch it brings the whole (D*S x n tile) cell tile of
// data[t, p] into shared memory once, with 16-byte cp.async copies into the
// other of two buffers while the sums of the present patch run (one barrier a
// patch), and every chain of the tile takes its CORNERS rows from there.
// L2 -> SM traffic falls from C*T*P*CORNERS rows to the library times the
// number of chain tiles (4 at 2000 chains and LANES = 16); blocks of one
// (target, n tile) are neighbours in the grid, so their chain tiles stream
// the same cells through L2 together.  LANES threads spread along n serve one
// chain: a shared-memory read is one contiguous row segment (conflict-free)
// and the chain's weights are a broadcast.  A thread keeps 16 chains x 4
// samples of sums in registers (64 of its 128).  Per (chain, patch) one
// 16-byte entry {slip*rf, slip*(1-rf), sf, row offset} (K4: {slip, offset})
// is folded from the operands for a chunk of patches at a time, swizzled so
// that neither its writes nor its reads conflict; with shared onsets an entry
// serves every sample of the tile, and is folded again by the blocks of other
// targets and n tiles (no scratch array is allocated for the launch).  At
// D*S = 320 the two cell tiles of 64 samples take 160 KB and 8 patches of
// entries 64 KB of the 227 KB a block may use.  What bounds this variant is
// shared memory: the reads of the C*T*P*CORNERS rows at 128 bytes a clock and
// SM (a quarter of the float32 rate), beside which the copies into the tiles
// and the fold of the entries, which pass through the same unit, do not
// hide.  tools/bench_torch_stack.py --ablate reads each part's share of the
// time from builds with parts left out; PERF.md has the numbers.
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
// of the entries after the first chunk, 2: the tile copies after the first
// two, 4: the sums; mma only, 8: the tensor core products, 16: the ldmatrix
// loads), so that
// each part's share of the time can be read on a machine where no kernel
// profiler runs.  Such a build computes nothing of use.
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
// CT << chunk_shift entries.
template <int CORNERS, int LANES, typename E>
__global__ void __launch_bounds__(kTiledThreads, 1)
gf_stack_tiled_kernel(const Operands<E> a, const int chunk_shift) {
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

    float4 acc[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] = Vec<4>::zero();

    // the CORNERS rows of chain j * G + g at patch slot pp of the chunk
    auto add_chain = [&](int j, int pp, const E* tile) {
        const int cc = j * G + g;
        const entry_t e = ents[(cc << chunk_shift) + (pp ^ (cc & chunk_mask))];
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

    copy_tile(0, 0);
    for (int p = 0; p < P; ++p) {
        const int buf = p & 1;
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
        if (BEAT_ABLATE & 4) continue;
        const E* tile = tiles + buf * DS * NT + 4 * lane;
        // K3 on a whole chain tile runs its chains without a branch between
        // them, so the reads of one overlap the sums of the last; measured,
        // K4 (one row a chain) is faster with the branch
        if (CORNERS == 4 && nc == CT) {
#pragma unroll
            for (int j = 0; j < CPT; ++j) add_chain(j, pp, tile);
        } else {
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
                if (j * G < nc) add_chain(j, pp, tile);       // same for the whole block
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

template <int CORNERS, int LANES, typename E>
int launch_tiled(const Operands<E>& a, int chunk_shift, cudaStream_t stream) {
    constexpr int NT = 4 * LANES, CT = kTiledThreads / LANES * kChainsPerThread;
    const size_t smem = (size_t)2 * a.D * a.S * NT * sizeof(E) +
                        ((size_t)CT << chunk_shift) * sizeof(typename Entry<CORNERS>::type);
    const int n_tiles = (a.N + NT - 1) / NT;
    if (smem > kSmemPerBlock || n_tiles > 65535) return (int)cudaErrorInvalidValue;
    auto kernel = gf_stack_tiled_kernel<CORNERS, LANES, E>;
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
    const dim3 grid((a.C + CT - 1) / CT, n_tiles, a.T);
    kernel<<<grid, kTiledThreads, smem, stream>>>(a, chunk_shift);
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
// chunk_shift patches of entries.  The tiled variant needs rows of 4-sample
// columns aligned to their size (16 bytes of float, 8 of bf16_t), mma rows of
// 8-sample chunks on 16-byte boundaries (N % 8 == 0).
template <int CORNERS, typename E>
int launch(const Operands<E>& a, int variant, int lanes, int chunk_shift,
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
// `lanes` and `chunk_shift` are the plan of ops/gfstack.py::plan_stack.  The
// launch goes on `stream` (PyTorch's current stream) and does not
// synchronise.  Each returns cudaGetLastError() after the launch (0 =
// success).

// K3: data (T,P,D,S,N) f32; didx, slips, rtf (C,P); sidx, stf (C,T,P) or,
// with a target stride of 0, (C,1,P); out (C,T,N) f32.
extern "C" int beat_gf_stack_multilinear_f32(
    const float* data, const int32_t* didx, const int32_t* sidx, const float* slips,
    const float* rtf, const float* stf, float* out, int C, int T, int P, int D, int S, int N,
    int64_t didx_c, int64_t sidx_c, int64_t sidx_t, int64_t slips_c, int64_t rtf_c,
    int64_t stf_c, int64_t stf_t, int variant, int lanes, int chunk_shift, void* stream) {
    const Operands<float> a{data, didx, sidx, slips, rtf, stf, out, C, T, P, D, S, N,
                            {didx_c, sidx_c, sidx_t, slips_c, rtf_c, stf_c, stf_t}};
    return launch<4>(a, variant, lanes, chunk_shift, (cudaStream_t)stream);
}

// K4: as K3 without rtf and stf.
extern "C" int beat_gf_stack_nearest_f32(
    const float* data, const int32_t* didx, const int32_t* sidx, const float* slips, float* out,
    int C, int T, int P, int D, int S, int N, int64_t didx_c, int64_t sidx_c, int64_t sidx_t,
    int64_t slips_c, int variant, int lanes, int chunk_shift, void* stream) {
    const Operands<float> a{data, didx, sidx, slips, nullptr, nullptr, out, C, T, P, D, S, N,
                            {didx_c, sidx_c, sidx_t, slips_c, 0, 0, 0}};
    return launch<1>(a, variant, lanes, chunk_shift, (cudaStream_t)stream);
}

// K3 and K4 on a bf16 library (bits of torch.bfloat16); the other operands and
// the output as above, float32.
extern "C" int beat_gf_stack_multilinear_bf16(
    const uint16_t* data, const int32_t* didx, const int32_t* sidx, const float* slips,
    const float* rtf, const float* stf, float* out, int C, int T, int P, int D, int S, int N,
    int64_t didx_c, int64_t sidx_c, int64_t sidx_t, int64_t slips_c, int64_t rtf_c,
    int64_t stf_c, int64_t stf_t, int variant, int lanes, int chunk_shift, void* stream) {
    const Operands<bf16_t> a{data, didx, sidx, slips, rtf, stf, out, C, T, P, D, S, N,
                             {didx_c, sidx_c, sidx_t, slips_c, rtf_c, stf_c, stf_t}};
    return launch<4>(a, variant, lanes, chunk_shift, (cudaStream_t)stream);
}

extern "C" int beat_gf_stack_nearest_bf16(
    const uint16_t* data, const int32_t* didx, const int32_t* sidx, const float* slips,
    float* out, int C, int T, int P, int D, int S, int N, int64_t didx_c, int64_t sidx_c,
    int64_t sidx_t, int64_t slips_c, int variant, int lanes, int chunk_shift, void* stream) {
    const Operands<bf16_t> a{data, didx, sidx, slips, nullptr, nullptr, out, C, T, P, D, S,
                             N, {didx_c, sidx_c, sidx_t, slips_c, 0, 0, 0}};
    return launch<1>(a, variant, lanes, chunk_shift, (cudaStream_t)stream);
}
