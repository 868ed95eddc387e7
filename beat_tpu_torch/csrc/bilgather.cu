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
//
// K1c and K2c on Hopper: the gather fused with the moment-tensor
// contraction, and its transpose.  With L = M/6 (one component segment of a
// row, L = 2·nf) and T_c(q)[k] the segment k of corner c of query q:
//
//   K1c  out[q, j]   = sum_{c<4} sum_{k<6} A[q, c, k] · T_c(q)[k][j]   (n, L)
//   K2c  P[q, c, k]  = sum_j G[q, j] · T_c(q)[k][j]                    (n, 4, 6)
//
// K1c replaces K1 (beat_tpu/ops/bilgather.py::_bilinear_rows_call, :47)
// together with the einsum of the m6 contraction that follows it
// (beat_tpu/heart/gftable.py:468); K2c replaces K2 (_corner_rows_call, :154,
// with the einsum of _bil_bwd, :296-304) together with the contraction's
// backward.  The unfused pair wrote and re-read (n, 6, L) blended rows and
// their cotangent, 1.48 GB each at 60,000 queries; the fused pair moves the
// (n, L) spectra or their cotangent (246 MB) and the (n, 24) coefficients.
//
// Bound: device-memory bandwidth on the (n, L) operand: ≈ 0.075 ms at 60,000
// queries × L = 1026, against 2.95 GFLOP (0.044 ms of FP32 FFMA).  What held
// the unfused kernels back was the L2 → SM path: every query pulled its own
// four corner rows (5.9 GB).  On the forward's queries q = chain·T + target
// the chains of one target cluster in one or a few corner blocks, so:
//
// * a block owns one target and a tile of chains (queries `stride` apart;
//   64 chains for K1c, 256 for K2c), sorts their corner-row keys in shared
//   memory (bitonic, key = row << 32 | slot: a fixed order) and cuts the
//   sorted slots into groups that share a corner block;
// * each group's 24 segments cross L2 → SM once per block, not once per
//   query;
// * K1c: a thread owns float2 columns of L and holds the group's 24 segment
//   values of them in registers; per query it reads the query's 24
//   coefficients from shared memory (a broadcast) and writes one float2:
//   a (queries × 24) @ (24 × L) product with 48 FFMA per 6 shared loads;
// * K2c: groups of more than four queries go through a three-buffer
//   cp.async pipeline of (group, round of ≤ 32 queries, chunk of ≤ 304
//   columns) steps that stage the group's segments and the round's G rows,
//   both transposed so that a lane reads one column's 24 segments and 4
//   queries as 7 float4s; a warp keeps 4 × 24 partial sums in registers (a
//   (queries × L) @ (L × 24) product with 96 FFMA per 7 shared loads), a
//   team of warps splits the columns of a round with few queries, and the
//   lanes' sums are combined by recursive halving (5 shuffle rounds, 93
//   shuffles for 96 sums) and the team's in a fixed order.  One block an
//   SM (231 registers a thread).  Groups of at most four queries (every
//   group on random queries) skip the staging: a warp each, reading the
//   segments from L2 and G from HBM (streaming hint), the next column's
//   operands loaded before this column's sums.
//
// L ≡ 2 (mod 4) at every table the port builds (nf odd), so segments and
// rows of `out` are only 8-byte aligned: K1c uses float2, K2c 4-byte
// cp.async, never float4 global accesses.  G and A are read as scalars (any
// 4-byte alignment).  No atomics: each output value is summed by one thread
// or one warp (team) in a fixed order, so results are deterministic; they
// agree with the plain versions (corner rows, then einsum) to rounding, not
// bit for bit.

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

// ---------------------------------------------------------------------------
// K1c and K2c
// ---------------------------------------------------------------------------

// Measurement builds only (tools/bench_torch_contract.py): -DBEAT_ABLATE=n
// leaves parts of K1c/K2c out; the results are then of no use.  K2c: 1 no
// sums, 2 no staging copies; K1c: 16 no stores, 32 every group's segments
// from one row.
#ifndef BEAT_ABLATE
#define BEAT_ABLATE 0
#endif
constexpr int kTile1 = 64;          // chains of one target per K1c block
constexpr int kTile2 = 256;         // chains of one target per K2c block
static_assert(kTile1 <= 256 && kTile2 <= 256 && !(kTile1 & (kTile1 - 1)) &&
                  !(kTile2 & (kTile2 - 1)),
              "a block sorts a power of two of at most 256 queries");
constexpr int kCThreads = 256;
constexpr int kCWarps = kCThreads / 32;
constexpr int kSeg = 24;            // 4 corners × 6 components
constexpr int kQuad = 4;            // queries a K2c warp carries
constexpr int kRound = kCWarps * kQuad;     // queries a K2c pipeline step stages
constexpr int kStages = 3;          // K2c pipeline buffers
constexpr int kTPitch = 28;         // floats per column of a staged segment chunk
constexpr int kStageFloats = kTPitch + kRound;      // per column: 24 (+4) segments, 32 G rows
constexpr int kChunk = 304;         // widest K2c chunk: 3 × 60 × 304 floats = 219 KB

// The tile's queries, sorted by corner block and cut into groups.
template <int TILE>
struct TileGroups {
    unsigned long long key[TILE];   // row << 32 | slot, sorted; ~0 = empty
    int start[TILE + 1];            // group g is sorted slots [start[g], start[g+1])
    int qrow[TILE];                 // query index of sorted slot s
    int count[kCWarps];
};

// Fills `sh` for the block's (tile, target); returns the group count and
// sets *n_valid to the tile's query count.  Every thread must call it.
template <int TILE>
__device__ int group_tile(TileGroups<TILE>& sh, const int32_t* __restrict__ cd,
                          const int32_t* __restrict__ z0, int nz, int64_t n_chain,
                          int stride, int64_t tile0, int t, int* n_valid) {
    const int i = threadIdx.x;
    if (i < TILE) {
        const int64_t chain = tile0 + i;
        unsigned long long key = ~0ull;
        if (chain < n_chain) {
            const int64_t q = chain * stride + t;
            const unsigned row = (unsigned)cd[q] * (unsigned)nz + (unsigned)z0[q];
            key = ((unsigned long long)row << 32) | (unsigned)i;
        }
        sh.key[i] = key;
    }
    __syncthreads();
    for (int k = 2; k <= TILE; k <<= 1) {          // bitonic sort, ascending
        for (int j = k >> 1; j > 0; j >>= 1) {
            if (i < TILE) {
                const int p = i ^ j;
                if (p > i) {
                    const unsigned long long a = sh.key[i], b = sh.key[p];
                    if ((a > b) == ((i & k) == 0)) {
                        sh.key[i] = b;
                        sh.key[p] = a;
                    }
                }
            }
            __syncthreads();
        }
    }
    const int64_t left = n_chain - tile0;
    const int nv = left < TILE ? (int)left : TILE;
    const bool head = i < nv && (i == 0 || (sh.key[i] >> 32) != (sh.key[i - 1] >> 32));
    const unsigned ballot = __ballot_sync(0xffffffffu, head);
    const int lane = i & 31, warp = i >> 5;
    if (lane == 0) sh.count[warp] = __popc(ballot);
    if (i < nv) {
        sh.qrow[i] = (int)((tile0 + (int64_t)(sh.key[i] & 0xffffffffu)) * stride + t);
    }
    __syncthreads();
    int before = 0, ng = 0;
    for (int w = 0; w < kCWarps; ++w) {
        if (w < warp) before += sh.count[w];
        ng += sh.count[w];
    }
    if (head) sh.start[before + __popc(ballot & ((1u << lane) - 1u))] = i;
    if (i == 0) sh.start[ng] = nv;
    __syncthreads();
    *n_valid = nv;
    return ng;
}

// K1c: out[q, :] = sum_{c,k} A[q, c, k] · T_c(q)[k].  One block per
// (chain tile, target); a thread owns float2 columns and, per group, holds
// the 24 segments' values of its columns in registers.
__global__ void __launch_bounds__(kCThreads)
bilinear_contract_kernel(const float* __restrict__ tbl, const int32_t* __restrict__ cd,
                         const int32_t* __restrict__ z0, const float* __restrict__ A,
                         float* __restrict__ out, int64_t n_chain, int stride, int nz,
                         int L) {
    __shared__ TileGroups<kTile1> sh;
    __shared__ __align__(16) float As[kTile1 * kSeg];
    const int64_t tile = blockIdx.x / stride;
    const int t = (int)(blockIdx.x % stride);
    int nv;
    const int ng = group_tile(sh, cd, z0, nz, n_chain, stride, tile * kTile1, t, &nv);
    for (int e = threadIdx.x; e < nv * kSeg; e += kCThreads) {
        const int s = e / kSeg;
        As[e] = A[(int64_t)sh.qrow[s] * kSeg + (e - s * kSeg)];
    }
    __syncthreads();
    const int64_t M = 6 * (int64_t)L;
    const int64_t zstep = (int64_t)nz * M;
    for (int j2 = threadIdx.x; j2 < (L >> 1); j2 += kCThreads) {
        for (int grp = 0; grp < ng; ++grp) {
            const int s0 = sh.start[grp], s1 = sh.start[grp + 1];
            const float* r00 = tbl + (BEAT_ABLATE & 32 ? 0 : (int64_t)(sh.key[s0] >> 32) * M)
                               + 2 * j2;
            float2 T[kSeg];
#pragma unroll
            for (int k = 0; k < 6; ++k) {
                T[k] = __ldg(reinterpret_cast<const float2*>(r00 + k * L));
                T[6 + k] = __ldg(reinterpret_cast<const float2*>(r00 + M + k * L));
                T[12 + k] = __ldg(reinterpret_cast<const float2*>(r00 + zstep + k * L));
                T[18 + k] = __ldg(reinterpret_cast<const float2*>(r00 + zstep + M + k * L));
            }
            for (int s = s0; s < s1; ++s) {
                const float4* a = reinterpret_cast<const float4*>(As + s * kSeg);
                float ox = 0.f, oy = 0.f;
#pragma unroll
                for (int v = 0; v < kSeg / 4; ++v) {
                    const float4 w = a[v];
                    ox = fmaf(w.x, T[4 * v].x, ox);
                    oy = fmaf(w.x, T[4 * v].y, oy);
                    ox = fmaf(w.y, T[4 * v + 1].x, ox);
                    oy = fmaf(w.y, T[4 * v + 1].y, oy);
                    ox = fmaf(w.z, T[4 * v + 2].x, ox);
                    oy = fmaf(w.z, T[4 * v + 2].y, oy);
                    ox = fmaf(w.w, T[4 * v + 3].x, ox);
                    oy = fmaf(w.w, T[4 * v + 3].y, oy);
                }
                if (!(BEAT_ABLATE & 16) || ox == 1234.5f) {
                    __stcs(reinterpret_cast<float2*>(out + (int64_t)sh.qrow[s] * L + 2 * j2),
                           make_float2(ox, oy));
                }
            }
        }
    }
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}


// One recursive-halving round of the warp reduction: lanes with bit OFF
// keep the upper H values, the others the lower, each adding its partner's.
template <int H, int OFF>
__device__ __forceinline__ void halve(float (&v)[kQuad * kSeg], int lane) {
    const bool up = (lane & OFF) != 0;
#pragma unroll
    for (int x = 0; x < H; ++x) {
        const float send = up ? v[x] : v[H + x];
        const float keep = up ? v[H + x] : v[x];
        v[x] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
}

// The warp's 96 sums (query m, segment ck at m·24 + ck) over its lanes:
// after five rounds lane l holds the sums 3l, 3l+1, 3l+2 in v[0..2].
__device__ __forceinline__ void reduce_warp(float (&v)[kQuad * kSeg], int lane) {
    halve<48, 16>(v, lane);
    halve<24, 8>(v, lane);
    halve<12, 4>(v, lane);
    halve<6, 2>(v, lane);
    halve<3, 1>(v, lane);
}

// Writes lane l's three sums of reduce_warp for the first cnt queries.
__device__ __forceinline__ void store_sums(const float (&v)[kQuad * kSeg],
                                           float* __restrict__ P, const int* qrow, int cnt,
                                           int lane) {
#pragma unroll
    for (int u = 0; u < 3; ++u) {
        const int f = 3 * lane + u, m = f / kSeg;
        if (m < cnt) P[(int64_t)qrow[m] * kSeg + (f - m * kSeg)] = v[u];
    }
}

// A step of K2c's pipeline: chunk c of round r of group g.
struct Step {
    int g, r, c;
};

// The first group at or after g with more than kQuad queries, or ng.
__device__ __forceinline__ int staged_from(const TileGroups<kTile2>& sh, int g, int ng) {
    while (g < ng && sh.start[g + 1] - sh.start[g] <= kQuad) ++g;
    return g;
}

// The step after st; false when there is none.
__device__ __forceinline__ bool advance(Step& st, const TileGroups<kTile2>& sh, int ng,
                                        int nchunks) {
    if (++st.c < nchunks) return true;
    st.c = 0;
    if (++st.r * kRound < sh.start[st.g + 1] - sh.start[st.g]) return true;
    st.r = 0;
    st.g = staged_from(sh, st.g + 1, ng);
    return st.g < ng;
}

// Issues the copies of one step into `buf`, transposed so that a lane
// reads a column's operands as float4s: the group's 24 segments at
// buf[j·kTPitch + seg], then the round's G rows at buf[lc·kTPitch +
// (quad·lc + j)·4 + m] for query 4·quad + m; columns [c·lc, c·lc + w).
__device__ __forceinline__ void stage_step(float* buf, const Step& st,
                                           const TileGroups<kTile2>& sh,
                                           const float* __restrict__ tbl,
                                           const float* __restrict__ G, int64_t M,
                                           int64_t zstep, int L, int lc) {
    const int c0 = st.c * lc, w = min(lc, L - c0);
    const int s0 = sh.start[st.g] + kRound * st.r;
    const int nq = min(kRound, sh.start[st.g + 1] - s0);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float* r00 = tbl + (int64_t)(sh.key[sh.start[st.g]] >> 32) * M + c0;
    for (int seg = warp; seg < kSeg; seg += kCWarps) {           // a warp a row
        const int c = seg / 6, k = seg - 6 * c;
        const float* src = r00 + (c >> 1) * zstep + (c & 1) * M + k * L;
        for (int x = lane; x < w; x += 32) cp_async4(buf + x * kTPitch + seg, src + x);
    }
    float* gbuf = buf + lc * kTPitch;
    for (int i = warp; i < nq; i += kCWarps) {
        const float* src = G + (int64_t)sh.qrow[s0 + i] * L + c0;
        float* dst = gbuf + (i >> 2) * lc * 4 + (i & 3);
        for (int x = lane; x < w; x += 32) cp_async4(dst + 4 * x, src + x);
    }
}

// K2c: P[q, c, k] = <G[q, :], T_c(q)[k]>.  Same kind of blocks and groups
// as K1c.  Groups of more than four queries: the block walks their steps
// (group, round of up to 32 of its queries, chunk of lc columns) through a
// kStages-buffer cp.async pipeline, each step staging the group's 24
// segments and the round's G rows.  A warp carries up to four queries;
// where a round has fewer than eight quads, a team of warps shares a
// quad's columns and their sums are added in a fixed order.  Groups of at
// most four queries (all of them on random queries): a warp each, the
// segments and G straight from L2 and HBM, the next columns' loads issued
// before this column's sums.  One block an SM: the 96 sums a lane keeps
// need more than the 128 registers two blocks would leave.
__global__ void __launch_bounds__(kCThreads, 1)
contract_corner_dot_kernel(const float* __restrict__ tbl, const int32_t* __restrict__ cd,
                           const int32_t* __restrict__ z0, const float* __restrict__ G,
                           float* __restrict__ P, int64_t n_chain, int stride, int nz, int L,
                           int lc) {
    extern __shared__ __align__(16) float smem[];    // kStages × kStageFloats × lc
    __shared__ TileGroups<kTile2> sh;
    __shared__ float red[kCWarps][kQuad * kSeg];
    const int64_t tile = blockIdx.x / stride;
    const int t = (int)(blockIdx.x % stride);
    int nv;
    const int ng = group_tile(sh, cd, z0, nz, n_chain, stride, tile * kTile2, t, &nv);
    (void)nv;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t M = 6 * (int64_t)L;
    const int64_t zstep = (int64_t)nz * M;
    const int nchunks = (L + lc - 1) / lc;
    const int bufsize = kStageFloats * lc;
    float acc[kQuad * kSeg];

    const int first = staged_from(sh, 0, ng);
    Step ahead{first, 0, 0};
    bool more = first < ng;
#pragma unroll
    for (int p = 0; p < kStages - 1; ++p) {
        if (more) {
            if (!(BEAT_ABLATE & 2)) {
                stage_step(smem + p * bufsize, ahead, sh, tbl, G, M, zstep, L, lc);
            }
            more = advance(ahead, sh, ng, nchunks);
        }
        asm volatile("cp.async.commit_group;\n" ::);
    }
    Step cur{first, 0, 0};
    for (int s = 0; first < ng; ++s) {
        if (more) {
            float* buf = smem + (s + kStages - 1) % kStages * bufsize;
            if (!(BEAT_ABLATE & 2)) stage_step(buf, ahead, sh, tbl, G, M, zstep, L, lc);
            more = advance(ahead, sh, ng, nchunks);
        }
        asm volatile("cp.async.commit_group;\n" ::);
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));   // step s is in
        __syncthreads();
        const float* Ts = smem + s % kStages * bufsize;
        const int s0 = sh.start[cur.g] + kRound * cur.r;
        const int nq = min(kRound, sh.start[cur.g + 1] - s0);
        const int nquads = (nq + kQuad - 1) / kQuad;
        const int ts = nquads == 1 ? 8 : nquads == 2 ? 4 : nquads <= 4 ? 2 : 1;
        const int quad = warp / ts, member = warp - quad * ts;
        const int cnt = quad < nquads ? min(kQuad, nq - kQuad * quad) : 0;
        const int w = min(lc, L - cur.c * lc);
        if (cur.c == 0) {
#pragma unroll
            for (int x = 0; x < kQuad * kSeg; ++x) acc[x] = 0.f;
        }
        if (cnt > 0 && !(BEAT_ABLATE & 1)) {
            const float4* gq = reinterpret_cast<const float4*>(Ts + lc * kTPitch) + quad * lc;
#pragma unroll 2
            for (int j = lane + 32 * member; j < w; j += 32 * ts) {
                const float4 g4 = gq[j];
                const float gv[kQuad] = {g4.x, cnt > 1 ? g4.y : 0.f, cnt > 2 ? g4.z : 0.f,
                                         cnt > 3 ? g4.w : 0.f};
                const float4* tj = reinterpret_cast<const float4*>(Ts + j * kTPitch);
#pragma unroll
                for (int v = 0; v < kSeg / 4; ++v) {
                    const float4 t4 = tj[v];
                    const float tv[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
#pragma unroll
                        for (int m = 0; m < kQuad; ++m) {
                            acc[m * kSeg + 4 * v + u] =
                                fmaf(gv[m], tv[u], acc[m * kSeg + 4 * v + u]);
                        }
                    }
                }
            }
        }
        if (cur.c == nchunks - 1) {                     // the round is summed up
            if (cnt > 0) reduce_warp(acc, lane);
            if (ts == 1) {
                if (cnt > 0) store_sums(acc, P, sh.qrow + s0 + kQuad * quad, cnt, lane);
            } else {
                if (cnt > 0) {
#pragma unroll
                    for (int u = 0; u < 3; ++u) red[warp][3 * lane + u] = acc[u];
                }
                __syncthreads();
                if (cnt > 0 && member == 0) {
#pragma unroll
                    for (int u = 0; u < 3; ++u) {
                        float sum = red[warp][3 * lane + u];
                        for (int mm = 1; mm < ts; ++mm) sum += red[warp + mm][3 * lane + u];
                        acc[u] = sum;
                    }
                    store_sums(acc, P, sh.qrow + s0 + kQuad * quad, cnt, lane);
                }
            }
        }
        __syncthreads();                                 // buffer s % kStages is free
        if (!advance(cur, sh, ng, nchunks)) break;
    }

    int small = 0;
    for (int grp = 0; grp < ng; ++grp) {
        const int s0 = sh.start[grp], cnt = sh.start[grp + 1] - s0;
        if (cnt > kQuad || small++ % kCWarps != warp) continue;
        const float* r00 = tbl + (int64_t)(sh.key[s0] >> 32) * M;
        const float* corner[4] = {r00, r00 + M, r00 + zstep, r00 + zstep + M};
        const float* g[kQuad];
#pragma unroll
        for (int m = 0; m < kQuad; ++m) g[m] = G + (int64_t)sh.qrow[s0 + min(m, cnt - 1)] * L;
#pragma unroll
        for (int x = 0; x < kQuad * kSeg; ++x) acc[x] = 0.f;
        float gn[kQuad], tn[kSeg];                      // the next column's operands
#pragma unroll
        for (int m = 0; m < kQuad; ++m) gn[m] = m < cnt && lane < L ? __ldcs(g[m] + lane) : 0.f;
#pragma unroll
        for (int ck = 0; ck < kSeg; ++ck) {
            tn[ck] = lane < L ? __ldg(corner[ck / 6] + (ck % 6) * L + lane) : 0.f;
        }
        for (int j = lane; j < L; j += 32) {
            float gv[kQuad], tv[kSeg];
#pragma unroll
            for (int m = 0; m < kQuad; ++m) gv[m] = gn[m];
#pragma unroll
            for (int ck = 0; ck < kSeg; ++ck) tv[ck] = tn[ck];
            const int jn = j + 32;
#pragma unroll
            for (int m = 0; m < kQuad; ++m) gn[m] = m < cnt && jn < L ? __ldcs(g[m] + jn) : 0.f;
#pragma unroll
            for (int ck = 0; ck < kSeg; ++ck) {
                tn[ck] = jn < L ? __ldg(corner[ck / 6] + (ck % 6) * L + jn) : 0.f;
            }
#pragma unroll
            for (int ck = 0; ck < kSeg; ++ck) {
#pragma unroll
                for (int m = 0; m < kQuad; ++m) {
                    acc[m * kSeg + ck] = fmaf(gv[m], tv[ck], acc[m * kSeg + ck]);
                }
            }
        }
        reduce_warp(acc, lane);
        store_sums(acc, P, sh.qrow + s0, cnt, lane);
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

// The grid of K1c and K2c: one block per (chain tile, target), the n
// queries read as (n / stride chains, stride targets); 0 where the
// arguments do not fit (l odd, stride not dividing n, too many blocks).
static int64_t contract_blocks(int64_t n, int stride, int l, int tile) {
    if (l <= 0 || l % 2 != 0 || stride <= 0 || n % stride != 0) return 0;
    const int64_t blocks = (n / stride + tile - 1) / tile * stride;
    return blocks > 2147483647LL ? 0 : blocks;
}

// The chain tile of K1c (kernel 0) or K2c (kernel 1): the corner-block
// groups a call brings from L2 follow from it.
extern "C" int beat_contract_tile(int kernel) { return kernel == 0 ? kTile1 : kTile2; }

// K1c's plain C entry: tbl (CD, NZ, 6·l) float32, 8-byte aligned; cd, z0
// (n,) int32 clamped corners; a (n, 4, 6) and out (n, l) float32, out
// 8-byte aligned.  Same launch contract as K1's entry.
extern "C" int beat_bilinear_contract_f32(const float* tbl, const int32_t* cd,
                                          const int32_t* z0, const float* a, float* out,
                                          int64_t n, int stride, int nz, int l, void* stream) {
    if (n <= 0) return 0;
    const int64_t blocks = contract_blocks(n, stride, l, kTile1);
    if (blocks == 0) return (int)cudaErrorInvalidValue;
    bilinear_contract_kernel<<<(unsigned int)blocks, kCThreads, 0, (cudaStream_t)stream>>>(
        tbl, cd, z0, a, out, n / stride, stride, nz, l);
    return (int)cudaGetLastError();
}

// K2c's plain C entry: g (n, l) float32, any 4-byte alignment; p (n, 4, 6)
// float32.  The kStages staging buffers, (24 segments + 32 G rows) × lc
// floats each, are dynamic shared memory.
extern "C" int beat_contract_corner_dot_f32(const float* tbl, const int32_t* cd,
                                            const int32_t* z0, const float* g, float* p,
                                            int64_t n, int stride, int nz, int l,
                                            void* stream) {
    if (n <= 0) return 0;
    const int64_t blocks = contract_blocks(n, stride, l, kTile2);
    if (blocks == 0) return (int)cudaErrorInvalidValue;
    static bool configured = false;
    if (!configured) {
        cudaError_t e = cudaFuncSetAttribute(
            contract_corner_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            kStages * kStageFloats * kChunk * (int)sizeof(float));
        if (e == cudaSuccess) {
            e = cudaFuncSetAttribute(contract_corner_dot_kernel,
                                     cudaFuncAttributePreferredSharedMemoryCarveout,
                                     (int)cudaSharedmemCarveoutMaxShared);
        }
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    // chunks of near-equal widths, none wider than kChunk
    const int nchunks = (l + kChunk - 1) / kChunk;
    const int lc = (l + nchunks - 1) / nchunks;
    const size_t smem = (size_t)kStages * kStageFloats * lc * sizeof(float);
    contract_corner_dot_kernel<<<(unsigned int)blocks, kCThreads, smem,
                                 (cudaStream_t)stream>>>(tbl, cd, z0, g, p, n / stride, stride,
                                                         nz, l, lc);
    return (int)cudaGetLastError();
}
