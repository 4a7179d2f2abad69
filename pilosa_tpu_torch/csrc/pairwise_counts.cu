// K4: pairwise intersect-count matrix ("popcount-GEMM"), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel behind `pairwise_counts_stack`
// (pilosa_tpu/ops/pallas_kernels.py:373, body `_pairwise_kernel` :318,
// call :361): out[i, j] = Σ_w popcount(a[i, w] & filt[w] & b[j, w]) over
// row stacks a [R1, T] and b [R2, T] of uint32 words (int32 on the
// PyTorch side), T = S·W, filter optional. Counts are exact 64-bit
// (the TPU kernel accumulated int32 behind a 2^31-bit gate).
//
// Bound. Bytes are (R1·T + R2·T + T)·4; operations are R1·R2·T population
// counts, and the SM issues 16 of them per clock (CUDA C Programming
// Guide, arithmetic-instruction throughput, compute capability 9.0). At
// a full tile (R1 = R2 = 102, S = 10) that is 3.41e9 POPC, ~0.8 ms at
// 132 SMs and 1.98 GHz against 80 us of bytes: compute-bound. At
// GroupBy's served shape (5 x 4, S = 10) it is bound by its 11.8 MB of
// bytes, and by latency: the whole read fits in one batch of loads.
//
// pairwise_small_kernel<RA, RB, U> (R1 = RA, R2 = RB, both 1..8, one
// instantiation per exact shape, so no padding row costs a load, a
// register, a shuffle or an atomic):
//  - the grid is a whole number of blocks per SM, from the occupancy of
//    the instantiation (fewer when the words run out first); when one
//    round of loads covers the words, each block owns one contiguous
//    slice of the word axis, of equal length rounded up to 8 vectors
//    (128 B), and the grid is then trimmed to the slices there are (at
//    5 x 4 x S = 10: 396 blocks planned, 394 slices of 208 vectors, so
//    two SMs run one block fewer); past that, blocks take chunks of
//    K4_THREADS · U vectors in turn, so that the grid sweeps the rows
//    together (a 1 x 1 tile at S = 954 was 3 % slower than its parent
//    with one long slice per block);
//  - a thread issues all of its evict-first 16-byte loads for U vectors
//    of every row (and of the filter) before its first popcount; the
//    ragged tail is clamped to the chunk's last vector and masked out of
//    the sum, so no load waits behind a guard. U = 8 / (RA + RB + 1)
//    vectors, at least 1: 2 at 1 x 1, 1 from 2 x 2 up (a budget of 16
//    vectors in flight was no faster at 5 x 4 or 1 x 1 and slower at
//    2 x 2 warm);
//  - sums are 32-bit in a thread and a warp (a thread counts at most
//    128 bits per vector it reads), 64-bit across warps; then each block
//    adds, per output, its count plus one arrival (bit 48 up) to a
//    per-stream state word with one atomic, and the block whose atomic
//    returns the last arrival writes the total to `out` and zeroes the
//    word. No fence, no ticket and no second pass: one atomic round trip
//    ends a block. `out` is written once and no memset precedes the
//    launch. (Partials per block summed by a last block, and a ticket
//    after atomic sums, were slower: each added round trips to L2.)
// Bound: the bytes, and the latency of one batch of loads. At 5 x 4 x
// S = 10 every block's loads are in flight together; with L2 just
// flushed by a write the last block's data arrives ~7.3 us after entry
// (the flush's dirty lines are written back as the rows come in).
//
// pairwise_tiled_kernel (anything larger): a block owns a 32-row A tile
// x 16-row B tile and one slice of the word axis; it stages K4_KW words
// of its A rows (filter applied), and of its B rows, in shared memory,
// so each word comes from HBM once per tile pair; each of its 8 warps
// owns an 8 x 8 sub-tile of pairs, its lanes split the staged words
// (consecutive lanes, consecutive words: no bank conflicts) and every
// thread keeps 64 sums in registers. Warps whose rows lie past R1 or R2
// skip the arithmetic (the test is warp-uniform). Concurrent blocks
// walk the tiles of one word slice, so a slice's rows stay in L2. Each
// block ends with a warp-shuffle reduce and one 64-bit atomicAdd per
// output it owns (the output is zeroed on the stream first). The
// word-slice count is capped at K4_MAX_SLICES, which bounds the atomics
// any one output sees. Ragged R1, R2 need no padding.
//
// Kernel parameters are scalars and raw pointers only: nothing is
// indexed at run time, so nothing spills to local memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define K4_THREADS 256
#define K4_WARPS (K4_THREADS / 32)
#define K4_TA 32        // A rows per tile: 4 warp rows x 8
#define K4_TB 16        // B rows per tile: 2 warp columns x 8
#define K4_KW 128       // words staged per step
#define K4_MAX_SLICES 256
#define K4_SMALL_MAX 8  // the small kernel takes R1, R2 <= 8
// a state word holds the blocks arrived above this bit, the count below
#define K4_ARRIVAL_SHIFT 48

__device__ __forceinline__ unsigned popc4(uint4 v) {
    return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
    return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ unsigned warp_sum32(unsigned v) {
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

// U: 16-byte vectors a thread loads per row in one round, about 8 in
// flight in all
constexpr int small_unroll(int ra, int rb) {
    return 8 / (ra + rb + 1) > 1 ? 8 / (ra + rb + 1) : 1;
}

template <int RA, int RB, int U>
__global__ void __launch_bounds__(K4_THREADS)
pairwise_small_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                      const uint4* __restrict__ filt, long long n_vec, long long chunk,
                      unsigned long long* __restrict__ state,
                      unsigned long long* __restrict__ out) {
    constexpr int P = RA * RB;
    __shared__ unsigned long long s_warp[K4_WARPS * P];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    unsigned acc[RA][RB];
    #pragma unroll
    for (int m = 0; m < RA; ++m)
        #pragma unroll
        for (int n = 0; n < RB; ++n) acc[m][n] = 0;
    // block b takes chunks b, b + G, b + 2G, ... (one chunk when the grid
    // covers the words in one round); the loop is uniform over the block
    // and its loads are not guarded
    for (long long r0 = (long long)blockIdx.x * chunk; r0 < n_vec;
         r0 += (long long)gridDim.x * chunk) {
        const long long end = min(r0 + chunk, n_vec);
        long long idx[U];
        #pragma unroll
        for (int u = 0; u < U; ++u)
            idx[u] = min(r0 + u * K4_THREADS + tid, end - 1);
        uint4 fv[U], av[RA][U], bv[RB][U];
        if (filt) {
            #pragma unroll
            for (int u = 0; u < U; ++u) fv[u] = __ldcs(filt + idx[u]);
        }
        #pragma unroll
        for (int m = 0; m < RA; ++m)
            #pragma unroll
            for (int u = 0; u < U; ++u) av[m][u] = __ldcs(a + m * n_vec + idx[u]);
        #pragma unroll
        for (int n = 0; n < RB; ++n)
            #pragma unroll
            for (int u = 0; u < U; ++u) bv[n][u] = __ldcs(b + n * n_vec + idx[u]);
        #pragma unroll
        for (int u = 0; u < U; ++u) {
            if (r0 + u * K4_THREADS + tid >= end) continue;  // clamped repeat
            #pragma unroll
            for (int m = 0; m < RA; ++m) {
                const uint4 x = filt ? and4(av[m][u], fv[u]) : av[m][u];
                #pragma unroll
                for (int n = 0; n < RB; ++n) acc[m][n] += popc4(and4(x, bv[n][u]));
            }
        }
    }

    // block partials: 32-bit warp sums, 64-bit across the block's warps
    #pragma unroll
    for (int m = 0; m < RA; ++m)
        #pragma unroll
        for (int n = 0; n < RB; ++n) {
            const unsigned v = warp_sum32(acc[m][n]);
            if (lane == 0) s_warp[warp * P + m * RB + n] = v;
        }
    __syncthreads();
    if (tid < P) {
        unsigned long long v = 0;
        #pragma unroll
        for (int w = 0; w < K4_WARPS; ++w) v += s_warp[w * P + tid];
        // one atomic adds the count and one arrival; the last block to
        // arrive has the total and leaves the state word zero
        const unsigned long long old =
            atomicAdd(state + tid, (1ull << K4_ARRIVAL_SHIFT) + v);
        if ((old >> K4_ARRIVAL_SHIFT) == gridDim.x - 1) {
            out[tid] = (old + v) & ((1ull << K4_ARRIVAL_SHIFT) - 1);
            state[tid] = 0;
        }
    }
}

__global__ void __launch_bounds__(K4_THREADS, 2)
pairwise_tiled_kernel(const uint4* __restrict__ a, int n_a,
                      const uint4* __restrict__ b, int n_b,
                      const uint4* __restrict__ filt, long long n_words,
                      int tiles_b, int n_tiles, long long slice_words,
                      unsigned long long* __restrict__ out) {
    __shared__ __align__(16) uint32_t sA[K4_TA][K4_KW];
    __shared__ __align__(16) uint32_t sB[K4_TB][K4_KW];
    const int tile = blockIdx.x % n_tiles;   // tiles vary fastest
    const long long slice = blockIdx.x / n_tiles;
    const int a0 = (tile / tiles_b) * K4_TA, b0 = (tile % tiles_b) * K4_TB;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wa = warp >> 1, wb = warp & 1;  // 4 x 2 warps of 8 x 8 pairs
    const int ra = a0 + wa * 8, rb = b0 + wb * 8;
    const bool active = ra < n_a && rb < n_b;  // warp-uniform
    const long long n_vec = n_words / 4;
    const long long w_begin = slice * slice_words;
    long long w_end = w_begin + slice_words;
    if (w_end > n_words) w_end = n_words;

    unsigned acc[8][8];
    #pragma unroll
    for (int m = 0; m < 8; ++m)
        #pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] = 0;

    const int vecs_per_row = K4_KW / 4;
    for (long long w0 = w_begin; w0 < w_end; w0 += K4_KW) {
        for (int k = threadIdx.x; k < (K4_TA + K4_TB) * vecs_per_row; k += K4_THREADS) {
            const int row = k / vecs_per_row, v = k % vecs_per_row;
            const long long vi = w0 / 4 + v;
            uint4 x = make_uint4(0, 0, 0, 0);
            if (vi * 4 < w_end) {
                if (row < K4_TA) {
                    const int r = a0 + row;
                    if (r < n_a) {
                        x = __ldg(a + (long long)r * n_vec + vi);
                        if (filt) x = and4(x, __ldg(filt + vi));
                    }
                } else {
                    const int r = b0 + row - K4_TA;
                    if (r < n_b) x = __ldg(b + (long long)r * n_vec + vi);
                }
            }
            uint4* dst = row < K4_TA ? (uint4*)&sA[row][v * 4]
                                     : (uint4*)&sB[row - K4_TA][v * 4];
            *dst = x;
        }
        __syncthreads();
        if (active) {
            #pragma unroll
            for (int j = 0; j < K4_KW / 32; ++j) {
                const int w = lane + 32 * j;
                uint32_t av[8], bv[8];
                #pragma unroll
                for (int m = 0; m < 8; ++m) av[m] = sA[wa * 8 + m][w];
                #pragma unroll
                for (int n = 0; n < 8; ++n) bv[n] = sB[wb * 8 + n][w];
                #pragma unroll
                for (int m = 0; m < 8; ++m)
                    #pragma unroll
                    for (int n = 0; n < 8; ++n) acc[m][n] += __popc(av[m] & bv[n]);
            }
        }
        __syncthreads();
    }
    if (!active) return;
    #pragma unroll
    for (int m = 0; m < 8; ++m)
        #pragma unroll
        for (int n = 0; n < 8; ++n) {
            const unsigned long long v = warp_sum(acc[m][n]);
            if (lane == 0 && v && ra + m < n_a && rb + n < n_b)
                atomicAdd(out + (long long)(ra + m) * n_b + (rb + n), v);
        }
}

template <typename Kernel>
static int resident_blocks(Kernel kernel) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, K4_THREADS, 0);
    if (sms < 1) sms = 132;
    if (per_sm < 1) per_sm = 1;
    return sms * per_sm;
}

// The small kernel's grid for n_vec vectors: a whole number of blocks
// per SM (at most the instantiation's occupancy) while every block gets
// at least one vector per thread, else one block per K4_THREADS vectors.
// Sets *chunk to the vectors a block takes per round: an equal slice,
// a multiple of 8 vectors (128 B), when one round covers the words, else
// K4_THREADS · U (the slice would need more than one batch of loads).
template <int RA, int RB>
static long long small_grid(long long n_vec, long long* chunk) {
    constexpr int U = small_unroll(RA, RB);
    // {SMs, resident blocks per SM}, set once (a thread-safe static)
    static const int2 card = [] {
        int dev = 0, sms = 0, occ = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ, pairwise_small_kernel<RA, RB, U>, K4_THREADS, 0);
        return make_int2(sms < 1 ? 132 : sms, occ < 1 ? 1 : occ);
    }();
    const int sms = card.x, occ = card.y;
    const long long wave = (long long)sms * K4_THREADS;
    long long grid;
    if (n_vec >= wave) {
        long long bps = (n_vec + wave - 1) / wave;
        grid = (long long)sms * (bps < occ ? bps : occ);
    } else {
        grid = (n_vec + K4_THREADS - 1) / K4_THREADS;
    }
    long long per = (n_vec + grid - 1) / grid;
    per = (per + 7) / 8 * 8;
    if (per > (long long)K4_THREADS * U) per = (long long)K4_THREADS * U;
    *chunk = per;
    const long long chunks = (n_vec + per - 1) / per;
    return chunks < grid ? chunks : grid;
}

template <int RA, int RB>
static void launch_small(const void* a, const void* b, const void* filt,
                         long long n_vec, unsigned long long* state,
                         unsigned long long* out, cudaStream_t s) {
    long long chunk = 0;
    const long long grid = small_grid<RA, RB>(n_vec, &chunk);
    pairwise_small_kernel<RA, RB, small_unroll(RA, RB)>
        <<<(unsigned)grid, K4_THREADS, 0, s>>>(
            (const uint4*)a, (const uint4*)b, (const uint4*)filt, n_vec, chunk,
            state, out);
}

// Calls f(std::integral_constant<int, RA>, std::integral_constant<int, RB>)
// for 1 <= n_a, n_b <= K4_SMALL_MAX.
template <int RA, typename F>
static void small_shape_b(int n_b, F&& f) {
    using std::integral_constant;
    switch (n_b) {
        case 1: f(integral_constant<int, RA>(), integral_constant<int, 1>()); break;
        case 2: f(integral_constant<int, RA>(), integral_constant<int, 2>()); break;
        case 3: f(integral_constant<int, RA>(), integral_constant<int, 3>()); break;
        case 4: f(integral_constant<int, RA>(), integral_constant<int, 4>()); break;
        case 5: f(integral_constant<int, RA>(), integral_constant<int, 5>()); break;
        case 6: f(integral_constant<int, RA>(), integral_constant<int, 6>()); break;
        case 7: f(integral_constant<int, RA>(), integral_constant<int, 7>()); break;
        default: f(integral_constant<int, RA>(), integral_constant<int, 8>()); break;
    }
}

template <typename F>
static void small_shape(int n_a, int n_b, F&& f) {
    switch (n_a) {
        case 1: small_shape_b<1>(n_b, f); break;
        case 2: small_shape_b<2>(n_b, f); break;
        case 3: small_shape_b<3>(n_b, f); break;
        case 4: small_shape_b<4>(n_b, f); break;
        case 5: small_shape_b<5>(n_b, f); break;
        case 6: small_shape_b<6>(n_b, f); break;
        case 7: small_shape_b<7>(n_b, f); break;
        default: small_shape_b<8>(n_b, f); break;
    }
}

static bool is_small(int n_a, int n_b) {
    return n_a >= 1 && n_b >= 1 && n_a <= K4_SMALL_MAX && n_b <= K4_SMALL_MAX;
}

// Plain C entry point, bound with ctypes. `a` is [n_a, n_words], `b`
// [n_b, n_words], `filt` [n_words] or NULL (all 16-byte aligned, n_words
// a multiple of 4); `out` is n_a x n_b uint64, row-major. For
// 1 <= n_a, n_b <= 8 the small kernel writes `out`, and `state` is
// n_a · n_b uint64 that are 0 and that no launch on another stream uses;
// the launch leaves them 0. Otherwise `state` is unused, `out` is zeroed
// on the stream and the tiled kernel adds into it. Launches on `stream`.
// Returns cudaGetLastError().
extern "C" int pairwise_counts_launch(const void* a, int n_a, const void* b, int n_b,
                                      const void* filt, long long n_words,
                                      void* out, void* state, void* stream) {
    if (n_a < 0 || n_b < 0 || n_words < 0 || n_words % 4 != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const long long n_vec = n_words / 4;
    unsigned long long* o = (unsigned long long*)out;
    if (is_small(n_a, n_b) && n_vec > 0) {
        // a warp's 32-bit sums stay below 2^32 while a row is under 2^36
        // words (256 GiB); the grid is far below 2^16 arrivals
        if (!state || n_words >= (1LL << 36)) return (int)cudaErrorInvalidValue;
        small_shape(n_a, n_b, [&](auto ra, auto rb) {
            launch_small<decltype(ra)::value, decltype(rb)::value>(
                a, b, filt, n_vec, (unsigned long long*)state, o, s);
        });
        return (int)cudaGetLastError();
    }
    cudaError_t err = cudaMemsetAsync(
        out, 0, sizeof(unsigned long long) * (size_t)n_a * (size_t)n_b, s);
    if (err != cudaSuccess) return (int)err;
    if (n_a == 0 || n_b == 0 || n_vec == 0) return (int)cudaGetLastError();
    static const int cap = resident_blocks(pairwise_tiled_kernel);
    const int tiles_a = (n_a + K4_TA - 1) / K4_TA;
    const int tiles_b = (n_b + K4_TB - 1) / K4_TB;
    const long long n_tiles = (long long)tiles_a * tiles_b;
    const long long steps = (n_words + K4_KW - 1) / K4_KW;
    long long n_slices = (2LL * cap + n_tiles - 1) / n_tiles;
    if (n_slices > K4_MAX_SLICES) n_slices = K4_MAX_SLICES;
    if (n_slices > steps) n_slices = steps;
    if (n_slices < 1) n_slices = 1;
    const long long slice_words = ((steps + n_slices - 1) / n_slices) * K4_KW;
    n_slices = (n_words + slice_words - 1) / slice_words;
    const long long grid = n_tiles * n_slices;
    if (n_tiles > 0x7fffffffLL || grid > 0x7fffffffLL)
        return (int)cudaErrorInvalidConfiguration;
    pairwise_tiled_kernel<<<(unsigned)grid, K4_THREADS, 0, s>>>(
        (const uint4*)a, n_a, (const uint4*)b, n_b, (const uint4*)filt, n_words,
        tiles_b, (int)n_tiles, slice_words, o);
    return (int)cudaGetLastError();
}
