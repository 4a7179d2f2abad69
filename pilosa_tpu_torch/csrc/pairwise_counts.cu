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
// GroupBy's served shape (5 x 4, S = 10) it is bound by its 13 MB of
// bytes. Two kernels share the reduction:
//  - pairwise_small_kernel<MA, MB> (R1 <= MA, R2 <= MB, MA, MB in
//    {1, 2, 4, 8}): every thread holds all R1 x R2 sums in registers and
//    grid-strides over 16-byte word vectors, loading each A, B and filter
//    vector once; nothing is staged, since no word is used by two threads.
//  - pairwise_tiled_kernel (anything larger): a block owns a 32-row A tile
//    x 16-row B tile and one slice of the word axis; it stages K4_KW words
//    of its A rows (filter applied), and of its B rows, in shared memory,
//    so each word comes from HBM once per tile pair; each of its 8 warps
//    owns an 8 x 8 sub-tile of pairs, its lanes split the staged words
//    (consecutive lanes, consecutive words: no bank conflicts) and every
//    thread keeps 64 sums in registers. Warps whose rows lie past R1 or R2
//    skip the arithmetic (the test is warp-uniform). Concurrent blocks
//    walk the tiles of one word slice, so a slice's rows stay in L2.
// Each block ends with a warp-shuffle reduce and one 64-bit atomicAdd per
// output it owns (the output is zeroed on the stream first). The
// word-slice count is capped at K4_MAX_SLICES, which bounds the atomics
// any one output sees. Ragged R1, R2 need no padding. Kernel parameters
// are scalars and raw pointers only: nothing is indexed at run time, so
// nothing spills to local memory.

#include <cuda_runtime.h>
#include <stdint.h>

#define K4_THREADS 256
#define K4_WARPS (K4_THREADS / 32)
#define K4_TA 32        // A rows per tile: 4 warp rows x 8
#define K4_TB 16        // B rows per tile: 2 warp columns x 8
#define K4_KW 128       // words staged per step
#define K4_MAX_SLICES 256

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

template <int MA, int MB>
__global__ void __launch_bounds__(K4_THREADS)
pairwise_small_kernel(const uint4* __restrict__ a, int n_a,
                      const uint4* __restrict__ b, int n_b,
                      const uint4* __restrict__ filt, long long n_vec,
                      unsigned long long* __restrict__ out) {
    __shared__ unsigned long long s_part[K4_WARPS][MA * MB];
    unsigned acc[MA][MB];
    #pragma unroll
    for (int m = 0; m < MA; ++m)
        #pragma unroll
        for (int n = 0; n < MB; ++n) acc[m][n] = 0;
    const long long stride = (long long)gridDim.x * K4_THREADS;
    const uint4 ones = make_uint4(~0u, ~0u, ~0u, ~0u);
    for (long long i = (long long)blockIdx.x * K4_THREADS + threadIdx.x;
         i < n_vec; i += stride) {
        const uint4 f = filt ? __ldg(filt + i) : ones;
        uint4 av[MA], bv[MB];
        #pragma unroll
        for (int m = 0; m < MA; ++m)
            av[m] = m < n_a ? and4(__ldg(a + m * n_vec + i), f)
                            : make_uint4(0, 0, 0, 0);
        #pragma unroll
        for (int n = 0; n < MB; ++n)
            bv[n] = n < n_b ? __ldg(b + n * n_vec + i) : make_uint4(0, 0, 0, 0);
        #pragma unroll
        for (int m = 0; m < MA; ++m)
            #pragma unroll
            for (int n = 0; n < MB; ++n) acc[m][n] += popc4(and4(av[m], bv[n]));
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    #pragma unroll
    for (int m = 0; m < MA; ++m)
        #pragma unroll
        for (int n = 0; n < MB; ++n) {
            const unsigned long long v = warp_sum(acc[m][n]);
            if (lane == 0) s_part[warp][m * MB + n] = v;
        }
    __syncthreads();
    for (int p = threadIdx.x; p < MA * MB; p += K4_THREADS) {
        const int m = p / MB, n = p % MB;
        if (m >= n_a || n >= n_b) continue;
        unsigned long long v = 0;
        #pragma unroll
        for (int w = 0; w < K4_WARPS; ++w) v += s_part[w][p];
        if (v) atomicAdd(out + (long long)m * n_b + n, v);
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

static int pow2_at_least(int n) {
    int p = 1;
    while (p < n) p <<= 1;
    return p;
}

template <int MA, int MB>
static void launch_small(const void* a, int n_a, const void* b, int n_b,
                         const void* filt, long long n_vec,
                         unsigned long long* out, cudaStream_t s) {
    static const int cap = resident_blocks(pairwise_small_kernel<MA, MB>);
    const long long want = (n_vec + K4_THREADS - 1) / K4_THREADS;
    long long grid = want < cap ? want : cap;
    if (grid > (long long)K4_MAX_SLICES * 4) grid = (long long)K4_MAX_SLICES * 4;
    pairwise_small_kernel<MA, MB><<<(unsigned)grid, K4_THREADS, 0, s>>>(
        (const uint4*)a, n_a, (const uint4*)b, n_b, (const uint4*)filt, n_vec, out);
}

#define K4_SMALL_B(MA)                                                        \
    switch (mb) {                                                             \
        case 1: launch_small<MA, 1>(a, n_a, b, n_b, filt, n_vec, o, s); break; \
        case 2: launch_small<MA, 2>(a, n_a, b, n_b, filt, n_vec, o, s); break; \
        case 4: launch_small<MA, 4>(a, n_a, b, n_b, filt, n_vec, o, s); break; \
        default: launch_small<MA, 8>(a, n_a, b, n_b, filt, n_vec, o, s); break; \
    }

// Plain C entry point, bound with ctypes. `a` is [n_a, n_words], `b`
// [n_b, n_words], `filt` [n_words] or NULL (all 16-byte aligned, n_words
// a multiple of 4). Zeroes `out` (n_a x n_b uint64, row-major) and
// launches on `stream`. Returns cudaGetLastError().
extern "C" int pairwise_counts_launch(const void* a, int n_a, const void* b, int n_b,
                                      const void* filt, long long n_words,
                                      void* out, void* stream) {
    if (n_a < 0 || n_b < 0 || n_words < 0 || n_words % 4 != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(
        out, 0, sizeof(unsigned long long) * (size_t)n_a * (size_t)n_b, s);
    if (err != cudaSuccess) return (int)err;
    const long long n_vec = n_words / 4;
    if (n_a == 0 || n_b == 0 || n_vec == 0) return (int)cudaGetLastError();
    unsigned long long* o = (unsigned long long*)out;
    if (n_a <= 8 && n_b <= 8) {
        const int ma = pow2_at_least(n_a), mb = pow2_at_least(n_b);
        switch (ma) {
            case 1: K4_SMALL_B(1); break;
            case 2: K4_SMALL_B(2); break;
            case 4: K4_SMALL_B(4); break;
            default: K4_SMALL_B(8); break;
        }
        return (int)cudaGetLastError();
    }
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
